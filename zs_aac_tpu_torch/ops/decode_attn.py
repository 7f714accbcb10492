"""Decode-step attention over the int8 KV cache (kernel K1).

Replaces the Pallas TPU kernel ``zs_aac_tpu/ops/decode_attn.py::_kernel``
with the hand-written Hopper kernel ``csrc/decode_attn.cu``. The function is
the attention of ``gpt2_step_q8`` (JAX ``models/gpt2.py`` lines 994-1007),
per layer and in the head-structured layout:

- quantize the new token's k and v per (b, h) (``quantize_vec``) and write
  them and their scales into row ``index`` of the cache, in place;
- scores over rows ``0..index``: ``(q . k8) * (k_scale / sqrt(d))``;
- the softmax; probabilities times ``v_scale``; ``o = sum_t p_t * v8[t]``.

The softmax is fp32 (``softmax_dtype=torch.float32``, the reference's), or
the beam search's opt-in bf16 softmax (``softmax_dtype=torch.bfloat16``, the
JAX ``gpt2_step_beam_q8`` branch at ``models/gpt2.py`` lines 467-474, behind
``--bf16_softmax``): the scores rounded to bf16, ``e = bf16(exp(bf16(s -
max)))``, an fp32 sum of ``e``, ``p = x.dtype(e) * x.dtype(1 / sum)``. The
kernel has an instantiation for each.

The activation-dtype roundings of the reference (the two score products,
the scaled probabilities and the output are ``x.dtype`` tensors there) are
kept, so in fp32 the kernel and the plain version differ only in summation
order, and in bf16 by at most a rounding step at those points.

Rows past ``index`` are not read. The reference masks them to -1e9 before
the softmax, which gives them an exact 0 weight, so reading only the valid
rows computes the same function.

Bound: bytes (each valid int8 row and its scales are read once; ~2 flops per
cache byte). One warp per (b, h); ``decode_attn_plan`` (a rule on the dtype,
the head dim and the rows read) picks the width of a lane's cache loads and
the warps a block. ``decode_attn_q8.launches`` counts kernel launches of
either softmax, ``decode_attn_q8.bf16_softmax_launches`` those of the bf16
one.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from zs_aac_tpu_torch.ops.quant import div, quantize_vec
from zs_aac_tpu_torch.utils.cuda_build import load_library

__all__ = ["bf16_softmax", "decode_attn_plan", "decode_attn_q8", "decode_attn_q8_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # activations, and the softmax's
_WARPS = 4             # (b, h) a block (kMaxWarps in csrc/decode_attn.cu)
_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a launch may take without opting in


def decode_attn_q8_plain(q, k_new, v_new, ck, cv, sk, sv, index: int,
                         softmax_dtype=torch.float32):
    """Plain PyTorch version of K1.

    q, k_new, v_new: [B, H, d] in the activation dtype; ck, cv: [B, H, T, d]
    int8 and sk, sv: [B, H, T] fp32, one layer's cache, updated in place at
    row ``index``. ``softmax_dtype``: ``torch.float32`` or ``torch.bfloat16``
    (the module docstring). Returns o [B, H, d] in q's dtype."""
    dt = q.dtype
    d = q.shape[-1]
    kq, ks = quantize_vec(k_new.float())
    vq, vs = quantize_vec(v_new.float())
    ck[:, :, index] = kq
    cv[:, :, index] = vq
    sk[:, :, index] = ks
    sv[:, :, index] = vs
    n = index + 1
    att = q[:, :, None, :] @ ck[:, :, :n].to(dt).transpose(-1, -2)   # [B,H,1,n]
    att = att * div(sk[:, :, None, :n], math.sqrt(d)).to(dt)
    if softmax_dtype == torch.float32:
        att = torch.softmax(att.float(), dim=-1)
    elif softmax_dtype == torch.bfloat16:
        att = bf16_softmax(att, dt)
    else:
        raise TypeError(f"decode_attn_q8: unsupported softmax dtype {softmax_dtype}")
    p = (att * sv[:, :, None, :n]).to(dt)
    return (p @ cv[:, :, :n].to(dt))[:, :, 0]


def bf16_softmax(s, dt):
    """The JAX beam steps' opt-in bf16 softmax over the last axis of the
    scores ``s``, in the activation dtype ``dt``: every step but the fp32
    sum rounds to bf16 (torch's bf16 ops compute in fp32 and round, as
    written), the probabilities come out in ``dt``."""
    sf = s.to(torch.bfloat16)
    e = torch.exp(sf - sf.amax(dim=-1, keepdim=True))
    denom = e.float().sum(dim=-1, keepdim=True)
    return e.to(dt) * (1.0 / denom).to(dt)


def decode_attn_plan(dtype, d: int, n_rows: int, softmax_dtype=torch.float32):
    """How K1 launches for activations of ``dtype``, head dim ``d``,
    ``n_rows`` = index + 1 cache rows read and the softmax in
    ``softmax_dtype``: ``(vec, warps)`` of the instantiation for that softmax
    (both keep an fp32 strip of scores, so the two take the same plan).

    - ``vec``: int8 values a lane reads of a cache row in one load, the
      widest of 16, 8, 4, 2, 1 bytes that divides ``d``; a row then takes
      ``d // vec`` lanes of the warp (at most 32: d = 64 is 4 lanes of 16
      bytes, d = 24 3 lanes of 8).
    - ``warps``: (b, h) a block, one warp each: 4, halved while the warps'
      score strips (``n_rows`` fp32 each) would pass 48 KB of shared memory.

    Raises ``TypeError`` for a dtype or softmax dtype the kernel does not take and
    ``ValueError`` for a head dim or a row count it does not take. A rule on
    shapes alone: a CUDA tensor launches what it names or raises."""
    if softmax_dtype not in _DTYPES:
        raise TypeError(f"decode_attn_q8: unsupported softmax dtype {softmax_dtype}")
    return _plan(dtype, d, n_rows)


@functools.lru_cache(maxsize=None)
def _plan(dtype, d, n_rows):
    if dtype not in _DTYPES:
        raise TypeError(f"decode_attn_q8: unsupported activation dtype {dtype}")
    if d <= 0 or n_rows <= 0:
        raise ValueError(f"decode_attn_q8: head dim {d}, {n_rows} rows")
    vec = next(v for v in (16, 8, 4, 2, 1) if d % v == 0)
    if d // vec > 32:
        raise ValueError(f"decode_attn_q8: head dim {d} is {d // vec} loads of {vec} bytes a "
                         "row; a warp takes at most 32")
    warps = _WARPS
    while warps > 1 and 4 * warps * n_rows > _SMEM_LIMIT:
        warps //= 2
    if 4 * warps * n_rows > _SMEM_LIMIT:
        raise ValueError(f"decode_attn_q8: {n_rows} cache rows need more than "
                         f"{_SMEM_LIMIT} bytes of shared memory")
    return vec, warps


def _check(q, k_new, v_new, ck, cv, sk, sv, index, softmax_dtype):
    # runs before each of the decode's launches: tuples and ints, compared once
    shape, dev = tuple(q.shape), q.get_device()
    B, H, d = shape
    T = ck.shape[2]
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if tuple(x.shape) != shape or x.dtype != q.dtype:
            raise ValueError(f"decode_attn_q8: {name} must match q "
                             f"({tuple(x.shape)} {x.dtype} vs {shape} {q.dtype})")
    for name, x in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if x.stride()[1:] != (d, 1):
            raise ValueError(f"decode_attn_q8: {name} rows must be contiguous [H, d]")
    for name, x, dtype, want in (("ck", ck, torch.int8, (B, H, T, d)),
                                 ("cv", cv, torch.int8, (B, H, T, d)),
                                 ("sk", sk, torch.float32, (B, H, T)),
                                 ("sv", sv, torch.float32, (B, H, T))):
        if x.dtype != dtype or tuple(x.shape) != want or not x.is_contiguous():
            raise ValueError(f"decode_attn_q8: {name} must be a contiguous "
                             f"{dtype} tensor of shape {want}")
    for x in (k_new, v_new, ck, cv, sk, sv):
        if x.get_device() != dev:
            raise ValueError("decode_attn_q8: all tensors must be on one device")
    if not 0 <= index < T:
        raise IndexError(f"decode_attn_q8: index {index} outside the cache [0, {T})")
    vec, warps = decode_attn_plan(q.dtype, d, index + 1, softmax_dtype)
    if ck.data_ptr() % vec or cv.data_ptr() % vec:
        raise ValueError(f"decode_attn_q8: the caches must be {vec}-byte aligned")
    return vec, warps


def _kernel():
    fn = load_library("decode_attn").decode_attn_q8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attn_q8(q, k_new, v_new, ck, cv, sk, sv, index: int, softmax_dtype=torch.float32):
    """K1: the plain version for CPU tensors, the CUDA kernel that
    ``decode_attn_plan`` names for CUDA tensors (same arguments and result as
    ``decode_attn_q8_plain``)."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attn_q8_plain(q, k_new, v_new, ck, cv, sk, sv, index, softmax_dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_attn_q8: no kernel for device {dev}")
    vec, warps = _check(q, k_new, v_new, ck, cv, sk, sv, index, softmax_dtype)
    B, H, d = q.shape
    fn = _kernel()
    o = torch.empty((B, H, d), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sm = _DTYPES[softmax_dtype]
    rc = fn(_DTYPES[q.dtype], sm, vec, warps,
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            q.stride(0), k_new.stride(0), v_new.stride(0),
            ck.data_ptr(), cv.data_ptr(), sk.data_ptr(), sv.data_ptr(), o.data_ptr(),
            B, H, ck.shape[2], d, int(index), float(math.sqrt(d)), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn_q8: kernel launch failed (cudaError {rc})")
    decode_attn_q8.launches += 1
    decode_attn_q8.bf16_softmax_launches += sm
    return o


decode_attn_q8.launches = 0
decode_attn_q8.bf16_softmax_launches = 0
