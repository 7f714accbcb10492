"""Operations of one batch of the GPT-2 captioner's greedy decode
(``programs/gpt2_caption.py``), from the shapes: every GEMM at 2 M N K and
the attention at 4 d a (query, key) pair, over the mapper, the prefill of
the prefix (its logits at every prompt position, as the port computes them)
and ``new_tokens`` cached steps (the loop steps once a token, the last
step's logits unused), each step's attention over rows 0..index. The
``_int_mm`` calls of one batch, as (M, K, N) with their count, feed the
int8-GEMM roofline."""


def int8_gemms(cfg: dict, B: int, new_tokens: int):
    """[(M, K, N, calls)] of one batch's ``torch._int_mm`` calls."""
    D, V, L = cfg["n_embd"], cfg["vocab_size"], cfg["n_layer"]
    Vp = -(-V // 8) * 8                               # the int8 lm-head, padded to 8 rows
    Lp = cfg["mapper"]["prefix_length"]
    per_layer = [(D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)]
    out = []
    for M, steps in ((B * Lp, 1), (B, new_tokens)):
        out += [(M, K, N, L * steps) for K, N in per_layer]
        out.append((M, D, Vp, steps))
    return out


def batch_ops(cfg: dict, B: int, new_tokens: int) -> float:
    D, H, L, V = cfg["n_embd"], cfg["n_head"], cfg["n_layer"], cfg["vocab_size"]
    d = D // H
    Lp = cfg["mapper"]["prefix_length"]
    sizes = cfg["mapper"]["sizes"]
    ops = sum(2.0 * B * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    ops += sum(2.0 * M * K * min(N, V) * calls for M, K, N, calls in int8_gemms(cfg, B, new_tokens))
    pairs = Lp * (Lp + 1) // 2 + sum(Lp + i + 1 for i in range(new_tokens))
    ops += 4.0 * d * H * L * B * pairs
    return ops
