"""An int8 GEMM (``torch._int_mm``: int8 [M, K] x int8 [K, N] -> int32
[M, N]): the least time of one call, 2 M N K operations at the int8 peak
against each operand read once and the int32 result written once."""

from benchmark.peaks import INT8_OPS, roofline_s


def bound(M: int, K: int, N: int) -> float:
    return roofline_s(2.0 * M * N * K, M * K + K * N + 4 * M * N, INT8_OPS)
