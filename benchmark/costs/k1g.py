"""Kernel K1g (``ops/decode_attn_gqa.py``, the int8-KV decode attention of
Mistral's grouped heads): the least time of one call at cache index
``index`` over the window ``lo..index``. q, k, v read and o written in the
activation dtype, and the step's cos and sin rows read; window rows
``lo..index-1`` of int8 K and V and their fp32 scales read, row ``index``
and its scales written (2 d + 8 bytes a row a kv head); 4 d operations a row
a query head (the scores and the value sum). Bytes bound it."""

from benchmark.peaks import FP32_FLOPS, roofline_s


def bound(B: int, H: int, KV: int, d: int, index: int, lo: int, act_bytes: int):
    """(seconds, bytes) of one call."""
    rows = index - lo + 1
    nbytes = (B * (2 * H + 2 * KV) * d * act_bytes + 2 * d * act_bytes
              + B * KV * rows * (2 * d + 8))
    flops = 4.0 * B * H * rows * d
    return roofline_s(flops, nbytes, FP32_FLOPS), nbytes
