"""Kernels K3 (a whole Swin block, ``mlp=True``) and K5 (window attention)
of ``ops/window_attn.py``: the least time of one call at a stage of B
images of H x H tokens, C channels. Per token the qkv, scores, p.v and
projection operations (plus fc1 and fc2 at hidden 4C) against x read, the
output written, the weights and the window bias read once."""

from benchmark.peaks import BF16_FLOPS, FP32_FLOPS, roofline_s


def bound(B: int, H: int, C: int, heads: int, window: int, itemsize: int, mlp: bool) -> float:
    tokens, N = B * H * H, window * window
    flops = tokens * (2 * C * 4 * C + 4 * N * C + (2 * C * 8 * C if mlp else 0))
    weights = (4 * C * C + (8 * C * C if mlp else 0)) * itemsize
    nbytes = 2 * tokens * C * itemsize + weights + (H // window) ** 2 * heads * N * N * 4
    return roofline_s(flops, nbytes, BF16_FLOPS if itemsize == 2 else FP32_FLOPS)
