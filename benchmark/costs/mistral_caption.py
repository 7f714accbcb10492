"""Operations of one batch of the Mistral captioner's greedy decode
(``programs/mistral_caption.py``), from the shapes: every GEMM at 2 M N K
(the base's, LoRA's two thin products at every site, the mapper's) and the
attention at 4 d a (query, key) pair, over the mapper, the prefill of the
prompt (prefix and language tag; logits at every prompt position) and
``new_tokens - 1`` cached steps (the first token comes from the prefill).
The base's ``_int_mm`` calls of one batch, as (M, K, N) with their count,
feed the int8-GEMM roofline."""


def _sites(cfg):
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    return D, I, kvd


def int8_gemms(cfg: dict, B: int, new_tokens: int, fused: bool):
    D, I, kvd = _sites(cfg)
    V, L = cfg["vocab_size"], cfg["num_hidden_layers"]
    Vp = -(-V // 8) * 8
    Lp = cfg["mapper"]["prefix_length"] + len(cfg["serving"]["tag_ids"])
    if fused:
        per_layer = [(D, D + 2 * kvd), (D, D), (D, 2 * I), (I, D)]
    else:
        per_layer = [(D, D), (D, kvd), (D, kvd), (D, D), (D, I), (D, I), (I, D)]
    out = []
    for M, steps in ((B * Lp, 1), (B, new_tokens - 1)):
        out += [(M, K, N, L * steps) for K, N in per_layer]
        out.append((M, D, Vp, steps))
    return out


def batch_ops(cfg: dict, B: int, new_tokens: int) -> float:
    D, I, kvd = _sites(cfg)
    V, L, H = cfg["vocab_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"]
    d, r = cfg["head_dim"], cfg["lora"]["r"]
    Lp = cfg["mapper"]["prefix_length"] + len(cfg["serving"]["tag_ids"])
    sizes = cfg["mapper"]["sizes"]
    ops = sum(2.0 * B * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    tokens = B * (Lp + new_tokens - 1)
    base = D * (D + 2 * kvd) + D * D + 3 * D * I
    lora = r * ((D + D) + 2 * (D + kvd) + (D + D) + 2 * (D + I) + (I + D))
    ops += 2.0 * tokens * L * (base + lora)
    ops += 2.0 * tokens * (D * V + r * (D + V))
    pairs = Lp * (Lp + 1) // 2 + sum(Lp + i + 1 for i in range(new_tokens - 1))
    ops += 4.0 * d * H * L * B * pairs
    return ops
