"""Kernel K1 (``ops/decode_attn.py``, the int8-KV decode attention): the
least time of one call. q, k, v read and o written in the activation dtype;
cache rows 0..index-1 of int8 K and V and their fp32 scales read, row
``index`` and its scales written; 4 d operations a valid row (the scores
and the value sum). Bytes bound it."""

from benchmark.peaks import FP32_FLOPS, roofline_s


def bound(B: int, H: int, d: int, index: int, act_bytes: int):
    """(seconds, bytes) of one call at cache index ``index``."""
    nbytes = B * H * (4 * d * act_bytes + (index + 1) * (2 * d + 8))
    flops = 4.0 * B * H * (index + 1) * d
    return roofline_s(flops, nbytes, FP32_FLOPS), nbytes
