"""A bf16 grouped GEMM (``torch._grouped_mm``: rows [T, K] sorted by group
times a weight [G, K, N] per group -> [T, N]): the least time of one call,
2 T K N operations at the bf16 peak against all G weights read once, the
rows read once and the outputs written once."""

from benchmark.peaks import BF16_FLOPS, roofline_s


def bound(T: int, K: int, N: int, G: int) -> float:
    return roofline_s(2.0 * T * K * N, 2.0 * (G * K * N + T * K + T * N), BF16_FLOPS)
