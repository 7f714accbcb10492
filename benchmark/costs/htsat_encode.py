"""Operations of one batch of the HTSAT encode (``programs/htsat_encode.py``),
from the shapes: the patch embedding, every Swin block's qkv, attention
(4 N C a token), projection and MLP (24 C^2 + 4 N C a token), the patch
mergings and the audio projection, at 2 M N K a GEMM (bf16 on the tensor
cores). The log-mel and the resize are left out (float32, a few percent).
``stage_blocks`` lists each block's stage shape for the kernels' bounds."""


def stage_blocks(clap: dict):
    """[(stage, H, C, heads, window)] per block (H x H tokens an image)."""
    h = clap["htsat"]
    res = h["spec_size"] // h["patch_size"]
    out = []
    for i, depth in enumerate(h["depths"]):
        C = h["embed_dim"] * 2 ** i
        w = min(h["window_size"], res)
        out += [(i, res, C, h["num_heads"][i], w)] * depth
        if i < len(h["depths"]) - 1:
            res //= 2
    return out


def batch_ops(clap: dict, B: int) -> float:
    h = clap["htsat"]
    ratio = h["mlp_ratio"]
    ps, ed = h["patch_size"], h["embed_dim"]
    tokens0 = (h["spec_size"] // ps) ** 2
    ops = 2.0 * B * tokens0 * ps * ps * ed
    blocks = stage_blocks(clap)
    for i, H, C, heads, w in blocks:
        t = B * H * H
        ops += t * (2 * C * 3 * C + 2 * C * C + 4 * w * w * C + 2 * 2 * C * ratio * C)
    last = {i: (H, C) for i, H, C, _, _ in blocks}
    for i in range(len(h["depths"]) - 1):
        H, C = last[i]
        ops += 2.0 * B * (H // 2) ** 2 * 4 * C * 2 * C
    nf, E = ed * 2 ** (len(h["depths"]) - 1), clap["embed_size"]
    return ops + 2.0 * B * (nf * E + E * E)
