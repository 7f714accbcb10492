"""Decode-step grouped-query attention over the int8 KV cache (kernel K1g).

One layer of ``models/mistral.py::mistral_step`` over the int8 cache, from
the projections to the attention's output (before ``wo``), the counterpart
of the JAX ``models/mistral.py::mistral_step`` int8 branch:

- RoPE (rotate-half) of the new token's q and k, in the activation dtype;
- the new k and v quantized per (b, kv head) (``quantize_vec``) and written
  with their scales into row ``index`` of the cache, in place;
- each kv head's ``H / KV`` query heads attend over the window
  ``lo..index``: scores ``(q . k8) * (k_scale / sqrt(d))`` in fp32, an fp32
  softmax, weights ``dtype(p * v_scale)``, ``o = dtype(sum_t w_t v8_t)``
  with an fp32 sum.

Rows outside the window are not read: the JAX step masks them to -1e9,
which gives them an exact 0 weight, so reading only the window computes the
same function.

``decode_attn_gqa_q8`` takes the plain version (``decode_attn_gqa_q8_plain``,
the step's own ATen chain) for CPU tensors and launches the hand-written
kernel ``csrc/decode_attn_gqa.cu`` for CUDA tensors, which differs from it
only in summation order. It is not K1 (``ops/decode_attn.py``): K1 serves
GPT-2's multi-head cache over the whole prefix and rounds the score products
to the activation dtype; this one serves a grouped cache over a sliding
window and keeps the scores in fp32.

Bound: bytes (each window row of int8 K and V and its scales is read once
per kv head; ~8 flops a cache byte at 4 query heads). The kernel runs a warp
per (b, kv head); ``decode_attn_gqa_plan`` picks the warps a block.
``decode_attn_gqa_q8.launches`` counts the launches; while a profiler
records, each is an operation named ``decode_attn_gqa_q8``
(``annotate(..., launch=True)``), so the trace files the kernel under the
span around it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from zs_aac_tpu_torch.ops.quant import div, quantize_vec
from zs_aac_tpu_torch.utils.cuda_build import load_library
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["rope_half", "decode_attn_gqa_plan", "decode_attn_gqa_q8",
           "decode_attn_gqa_q8_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_REPS = (2, 4)                # query heads a kv head: Mistral-7B's 4, the tiny configs' 2
_DIMS = (8, 16, 32, 64, 128)  # head dims: a row of d / 8 lanes, two rows a warp at least
_WARPS = 4                    # warps a block at most (kMaxWarps)
_SMEM_MAX = 232448            # dynamic shared memory a block may opt into (kSmemMax)


def rope_half(x, tables):
    """Rotate-half RoPE (HF Llama/Mistral convention) of x [..., d] with the
    (cos, sin) rows ``tables`` [..., d], in x's dtype."""
    cos, sin = tables
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def decode_attn_gqa_q8_plain(q, k, v, tables, ck, cv, sk, sv, index: int, lo: int):
    """Plain PyTorch version of K1g.

    q [B, H * d], k and v [B, KV * d] in the activation dtype, before RoPE;
    ``tables`` the step's (cos, sin) rows [1, d] in that dtype; ck, cv
    [B * KV, T, d] int8 and sk, sv [B * KV, T] fp32, one layer's cache,
    updated in place at row ``index``; the window is rows ``lo..index``.
    Returns o [B, H * d] in q's dtype."""
    B, KV = q.shape[0], sk.shape[0] // q.shape[0]
    d = ck.shape[-1]
    H = q.shape[1] // d
    rep, bg, dt = H // KV, B * KV, q.dtype
    hi = index + 1
    q = rope_half(q.reshape(B, 1, H, d).transpose(1, 2), tables)     # [B, H, 1, d]
    k = rope_half(k.reshape(B, 1, KV, d).transpose(1, 2), tables)    # [B, KV, 1, d]
    qk, s_k = quantize_vec(k[:, :, 0].float())
    qv, s_v = quantize_vec(v.reshape(B, KV, d).float())
    ck[:, index] = qk.reshape(bg, d)
    cv[:, index] = qv.reshape(bg, d)
    sk[:, index] = s_k.reshape(bg)
    sv[:, index] = s_v.reshape(bg)
    # int8 x activation products accumulate and stay in fp32 (the JAX step's
    # preferred_element_type), scales folded in
    qg = q[:, :, 0].reshape(bg, rep, d).float()
    att = torch.bmm(qg, ck[:, lo:hi].float().transpose(1, 2))       # [BG, rep, n]
    att = att * div(sk[:, None, lo:hi], math.sqrt(d))
    att = torch.softmax(att, dim=-1)
    att = (att * sv[:, None, lo:hi]).to(dt)
    o = torch.bmm(att.float(), cv[:, lo:hi].float())               # [BG, rep, d]
    return o.to(dt).reshape(B, H * d)


def _strip_bytes(n_rows, rep):
    """A warp's scores in shared memory (``strip_floats`` in the source)."""
    return -(-n_rows * rep // 4) * 16


@functools.lru_cache(maxsize=None)
def decode_attn_gqa_plan(dtype, d: int, rep: int, n_rows: int) -> int:
    """The warps a block (one (b, kv head) each) for K1g at activations of
    ``dtype``, head dim ``d``, ``rep`` query heads a kv head and a window of
    ``n_rows`` rows (the new one included): 4, fewer where four warps' scores
    (``n_rows * rep`` fp32 each) would pass what a block's shared memory may
    hold (3 at Mistral's 4,096-row sliding window).

    Raises ``TypeError`` for a dtype the kernel does not take and
    ``ValueError`` for a head dim, head ratio or window it does not take: the
    kernel is built for the ratios and head dims the port's configs have. A
    rule on shapes alone: a CUDA tensor launches what it names or raises."""
    if dtype not in _DTYPES:
        raise TypeError(f"decode_attn_gqa_q8: unsupported activation dtype {dtype}")
    if rep not in _REPS:
        raise ValueError(f"decode_attn_gqa_q8: {rep} query heads a kv head; takes {_REPS}")
    if d not in _DIMS or n_rows <= 0:
        raise ValueError(f"decode_attn_gqa_q8: head dim {d} (takes {_DIMS}), "
                         f"{n_rows} window rows")
    warps = min(_WARPS, _SMEM_MAX // _strip_bytes(n_rows, rep))
    if warps < 1:
        raise ValueError(f"decode_attn_gqa_q8: a window of {n_rows} rows needs more than "
                         f"{_SMEM_MAX} bytes of shared memory")
    return warps


def _kernel():
    fn = load_library("decode_attn_gqa").decode_attn_gqa_q8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, cos, sin, ck, cv, sk, sv, index, lo):
    """Shapes, dtypes and devices of a CUDA call -> (B, KV, d, rep)."""
    dt = q.dtype
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2 or ck.dim() != 3:
        raise ValueError("decode_attn_gqa_q8: q, k, v must be [B, heads * d], the cache "
                         "[B * KV, T, d]")
    B, (BG, T, d) = q.shape[0], ck.shape
    KV = BG // B if B else 0
    if KV <= 0 or BG != B * KV or q.shape[1] % (KV * d):
        raise ValueError(f"decode_attn_gqa_q8: q {tuple(q.shape)} does not fit the cache "
                         f"{tuple(ck.shape)}")
    for name, x, want in (("k", k, (B, KV * d)), ("v", v, (B, KV * d)), ("cos", cos, (1, d)),
                          ("sin", sin, (1, d))):
        if x.dtype != dt or tuple(x.shape) != want:
            raise ValueError(f"decode_attn_gqa_q8: {name} must be {dt} of shape {want} "
                             f"(got {x.dtype} {tuple(x.shape)})")
    if q.stride(1) != 1 or k.stride(1) != 1 or v.stride(1) != 1 or not (
            cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("decode_attn_gqa_q8: q, k, v rows and the tables must be contiguous")
    if (cv.shape != ck.shape or ck.dtype != torch.int8 or cv.dtype != torch.int8
            or sk.dtype != torch.float32 or sv.dtype != torch.float32
            or sk.shape != (BG, T) or sv.shape != (BG, T)
            or not (ck.is_contiguous() and cv.is_contiguous() and sk.is_contiguous()
                    and sv.is_contiguous())):
        raise ValueError("decode_attn_gqa_q8: the cache must be contiguous int8 k, v "
                         "[B * KV, T, d] and fp32 scales [B * KV, T]")
    dev = q.get_device()
    for x in (k, v, cos, sin, ck, cv, sk, sv):
        if x.get_device() != dev:
            raise ValueError("decode_attn_gqa_q8: all tensors must be on one CUDA device")
    if not 0 <= lo <= index < T:
        raise IndexError(f"decode_attn_gqa_q8: window {lo}..{index} outside the cache [0, {T})")
    return B, KV, d, q.shape[1] // (KV * d)


def decode_attn_gqa_q8(q, k, v, tables, ck, cv, sk, sv, index: int, lo: int):
    """K1g: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (same arguments and result as ``decode_attn_gqa_q8_plain``)."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise RuntimeError(f"decode_attn_gqa_q8: no kernel for device {q.device}")
        return decode_attn_gqa_q8_plain(q, k, v, tables, ck, cv, sk, sv, index, lo)
    cos, sin = tables
    B, KV, d, rep = _check(q, k, v, cos, sin, ck, cv, sk, sv, index, lo)
    warps = decode_attn_gqa_plan(q.dtype, d, rep, index - lo + 1)
    if ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("decode_attn_gqa_q8: the caches must be 16-byte aligned")
    fn = _kernel()
    o = q.new_empty((B, rep * KV * d))
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    with annotate("decode_attn_gqa_q8", launch=True):
        rc = fn(_DTYPES[q.dtype], rep, warps, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                q.stride(0), k.stride(0), v.stride(0), cos.data_ptr(), sin.data_ptr(),
                ck.data_ptr(), cv.data_ptr(), sk.data_ptr(), sv.data_ptr(), o.data_ptr(), B, KV,
                ck.shape[1], d, int(index), int(lo), float(math.sqrt(d)), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attn_gqa_q8: kernel launch failed (cudaError {rc})")
    decode_attn_gqa_q8.launches += 1
    return o


decode_attn_gqa_q8.launches = 0
