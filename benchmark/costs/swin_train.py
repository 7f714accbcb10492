"""Kernels K6-K9 of the Swin train step (``csrc/swin_train.cu``; K7 is K3's
kernel in train mode): the least time of one call at a stage of B images of
H x H tokens, C channels, 8 x 8 windows. Each input read once and each
output written once (activations and weights in the working dtype, bias
and gradients fp32), against the operations per token: K7 24C^2 + 4NC
(K3's), K8 40C^2 (fc1 recomputed, dgelu, dfc1 and dfc2, dLN2), K9 and K6
22C^2 + 12NC (qkv and proj recomputed, do, dq/dk/dv, dx, dWqkv, dWproj)."""

from benchmark.peaks import BF16_FLOPS, FP32_FLOPS, roofline_s


def bound(kind: str, B: int, H: int, C: int, heads: int, itemsize: int) -> float:
    tokens, N = B * H * H, 64
    bias = (H // 8) ** 2 * heads * N * N * 4
    act = tokens * C * itemsize
    if kind == "K7":
        flops = 24 * C * C + 4 * N * C
        nbytes = 3 * act + 12 * C * C * itemsize + bias
    elif kind == "K8":
        flops = 40 * C * C
        nbytes = 3 * act + (8 * C * C + 7 * C) * itemsize + (8 * C * C + 7 * C) * 4
    elif kind in ("K6", "K9"):
        flops = 22 * C * C + 12 * N * C
        nbytes = 3 * act + 4 * C * C * itemsize + 2 * bias + (4 * C * C + 6 * C) * 4
    else:
        raise ValueError(f"unknown train kernel {kind!r}")
    return roofline_s(tokens * flops, nbytes, BF16_FLOPS if itemsize == 2 else FP32_FLOPS)
