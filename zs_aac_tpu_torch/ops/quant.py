"""Symmetric int8 quantization helpers shared by the model and kernel K1,
and the two passes around every w8a8 GEMM.

The operation order is that of the JAX package (``models/gpt2.py``
``_quant_act`` and ``_quantize_vec``): abs-max, ``/ 127``, ``max(., 1e-8)``,
a true division ``x / scale``, round half to even, clip to +-127. Every
division here is by a tensor: on CUDA, PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal, which can differ in the last
bit and change an int8 value. The rescale of the GEMM's int32 result is
``(float(y) * sx) * w_scale``, cast to the output dtype, then ``+ bias`` in
the output dtype.

``quant_act`` and ``int8_rescale`` take the plain PyTorch versions
(``quant_act_plain``, ``int8_rescale_plain``) for CPU tensors and launch the
one-pass CUDA kernels of ``csrc/quant.cu`` for CUDA tensors, bitwise equal
to the plain versions for every finite input. ``quant_plan`` and
``rescale_plan`` pick each shape's instantiation. The kernels serve
inference only: a CUDA call whose input requires grad raises.
``quant_act.launches`` and ``int8_rescale.launches`` count the launches;
while a profiler records, each launch is an operation record
(``annotate(..., launch=True)``) inside the ``layer.quant`` or
``layer.rescale`` span, so the trace links the kernel to both.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from zs_aac_tpu_torch.utils.cuda_build import load_library
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["div", "quantize_vec", "quant_act", "quant_act_plain", "quant_plan",
           "int8_rescale", "int8_rescale_plain", "rescale_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # activations in, rescaled results out
_ITEMS = 8     # loads a quantize thread keeps in registers (csrc/quant.cu::kItems)
_BLOCK = 256   # threads a block the plans aim at


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (``x`` is fp32)."""
    return x / _const(float(c), x.device)


def quantize_vec(x: torch.Tensor):
    """x [..., d] fp32 -> (int8 values [..., d], fp32 scale [...])."""
    scale = torch.clamp_min(div(x.abs().amax(dim=-1), 127.0), 1e-8)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quant_act_plain(x: torch.Tensor):
    """Dynamic per-row int8 activation quantization: (int8 [..., K], fp32
    scale [..., 1]). The abs-max reduces in ``x``'s own dtype, which is
    exact."""
    sx = torch.clamp_min(div(x.abs().amax(dim=-1, keepdim=True).float(), 127.0), 1e-8)
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_rescale_plain(y, sx, w_scale, out_dtype, bias=None):
    """The w8a8 GEMM's int32 result y [..., N] -> ``out_dtype``: ``(float(y)
    * sx) * w_scale`` with sx [..., 1] and w_scale [N] fp32, cast, then
    ``+ bias`` if given."""
    out = (y.float() * sx * w_scale).to(out_dtype)
    return out if bias is None else out + bias


@functools.lru_cache(maxsize=None)
def quant_plan(K: int, dtype, align: int = 16):
    """How ``quant_act``'s kernel launches for rows of ``K`` elements of
    ``dtype`` whose starts are ``align``-byte aligned: ``(vec, tpr, rows)``.

    - ``vec``: elements a load, 16 bytes (4 fp32, 8 bf16) where ``K`` is a
      multiple of that and the rows are 16-byte aligned, else 1.
    - ``tpr``: threads a row, a warp or whole warps: the fewest (a power of
      two) that hold the row's ``K / vec`` loads in at most 8 each, the
      loads a thread keeps in registers.
    - ``rows``: rows a block, ``256 // tpr`` (at least 1): a warp a row and
      8 rows a block at K = 768, a block of 256 a row at K = 14,336 bf16.

    Raises ``TypeError`` for a dtype the kernel does not take, ``ValueError``
    for a ``K`` it does not take (at most 8,192 loads a row)."""
    if dtype not in _DTYPES:
        raise TypeError(f"quant_act: unsupported dtype {dtype}")
    if K <= 0:
        raise ValueError(f"quant_act: rows of {K} elements")
    wide = 16 // dtype.itemsize
    vec = wide if K % wide == 0 and align % 16 == 0 else 1
    loads = K // vec
    tpr = 32
    while tpr * _ITEMS < loads:
        tpr *= 2
    if tpr > 1024:
        raise ValueError(f"quant_act: a row of {K} elements is {loads} loads of {vec}; "
                         f"a block holds at most {1024 * _ITEMS}")
    return vec, tpr, max(1, _BLOCK // tpr)


@functools.lru_cache(maxsize=None)
def rescale_plan(N: int, out_dtype, align: int = 16):
    """How ``int8_rescale``'s kernel launches for int32 rows of ``N`` columns
    starting ``align``-byte aligned, rescaled to ``out_dtype``: ``(vec,
    threads)``.

    - ``vec``: columns a thread, the widest of 4, 2, 1 dividing ``N`` and
      fitting the alignment (4: a 16-byte int32 load);
    - ``threads``: a block's threads, one per ``vec`` columns of a column
      tile, at most 256 and as few whole warps as cover the row's tiles
      evenly (N = 768: 192; N = 2,304: three tiles of 192).

    Each thread takes 4 rows. Raises ``TypeError`` for an output dtype the
    kernel does not take, ``ValueError`` for ``N`` <= 0."""
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_rescale: unsupported output dtype {out_dtype}")
    if N <= 0:
        raise ValueError(f"int8_rescale: rows of {N} columns")
    vec = next(v for v in (4, 2, 1) if N % v == 0 and align % (4 * v) == 0)
    loads = N // vec
    tiles = -(-loads // _BLOCK)
    return vec, 32 * -(-loads // (32 * tiles))


def _alignment(t: torch.Tensor, *strides: int) -> int:
    """The largest power of two up to 16 dividing ``t``'s address and the
    given byte strides (a row's length)."""
    return math.gcd(t.data_ptr(), 16, *strides)


def _no_grad(name: str, *tensors):
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            raise RuntimeError(f"{name}: the CUDA kernel serves inference only and carries "
                               "no gradient; call it under torch.no_grad()")


def _quant_args(x: torch.Tensor):
    """Checks ``quant_act``'s CUDA input: (rows [M, K], contiguous,
    plan)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_act: unsupported dtype {x.dtype}")
    _no_grad("quant_act", x)
    if x.dim() == 0:
        raise ValueError("quant_act: needs rows [..., K]")
    K = x.shape[-1]
    rows = (x if x.dim() == 2 else x.reshape(-1, K)).contiguous()
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"quant_act: {rows.shape[0]} rows; at most 2**31 - 1")
    return rows, quant_plan(K, x.dtype, _alignment(rows, K * x.element_size()))


def _rescale_args(y, sx, w_scale, out_dtype, bias):
    """Checks ``int8_rescale``'s CUDA inputs; returns (M, N, plan)."""
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8_rescale: unsupported output dtype {out_dtype}")
    if y.dtype != torch.int32 or sx.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("int8_rescale: y must be int32, sx and w_scale float32 "
                        f"(got {y.dtype}, {sx.dtype}, {w_scale.dtype})")
    if bias is not None and bias.dtype != out_dtype:
        raise TypeError(f"int8_rescale: bias {bias.dtype} must be in the output dtype {out_dtype}")
    _no_grad("int8_rescale", sx, w_scale, bias)
    if y.dim() == 0:
        raise ValueError("int8_rescale: needs rows y [..., N]")
    N = y.shape[-1]
    plan = rescale_plan(N, out_dtype, _alignment(y))
    if tuple(sx.shape) != (*y.shape[:-1], 1):
        raise ValueError(f"int8_rescale: sx {tuple(sx.shape)} must be y's rows "
                         f"{tuple(y.shape[:-1])} by 1")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (N,):
            raise ValueError(f"int8_rescale: {name} {tuple(t.shape)} must be ({N},)")
    device = y.get_device()
    for name, t in (("y", y), ("sx", sx), ("w_scale", w_scale), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"int8_rescale: {name} must be contiguous")
        if t is not None and t.get_device() != device:
            raise ValueError("int8_rescale: all tensors must be on one device")
    M = y.numel() // N
    if M >= 2 ** 31:
        raise ValueError(f"int8_rescale: {M} rows; at most 2**31 - 1")
    return M, N, plan


_ARGTYPES = {   # the C entries of csrc/quant.cu
    "quant_act": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p],
    "int8_rescale": ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p]),
}


def _kernel(name: str):
    fn = getattr(load_library("quant"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (without
    the ``torch.cuda.Stream`` object that ``current_stream`` builds)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{name}: no kernel for device {x.device}")


def quant_act(x: torch.Tensor):
    """Dynamic per-row int8 activation quantization, x [..., K] fp32 or bf16
    -> (int8 [..., K], fp32 scale [..., 1]): the plain version for CPU
    tensors, the kernel ``quant_plan`` names for CUDA tensors. Span
    ``layer.quant``."""
    with annotate("layer.quant"):
        if not _device(x, "quant_act"):
            return quant_act_plain(x)
        rows, (vec, tpr, per_block) = _quant_args(x)
        M, K = rows.shape
        xq = x.new_empty(x.shape, dtype=torch.int8)
        sx = x.new_empty((*x.shape[:-1], 1), dtype=torch.float32)
        if M == 0:
            return xq, sx
        fn = _kernel("quant_act")
        stream = _stream(x)
        with annotate("quant_act", launch=True):
            rc = fn(_DTYPES[x.dtype], vec, tpr, per_block, rows.data_ptr(), xq.data_ptr(),
                    sx.data_ptr(), M, K, stream)
        if rc != 0:
            raise RuntimeError(f"quant_act: kernel launch failed (cudaError {rc})")
        quant_act.launches += 1
        return xq, sx


def int8_rescale(y, sx, w_scale, out_dtype, bias=None):
    """The w8a8 GEMM's int32 result y [..., N] -> ``out_dtype``, ``(float(y)
    * sx) * w_scale`` then ``+ bias`` (sx [..., 1] and w_scale [N] fp32,
    bias [N] in ``out_dtype``): the plain version for CPU tensors, the
    kernel ``rescale_plan`` names for CUDA tensors. Span ``layer.rescale``."""
    with annotate("layer.rescale"):
        if not _device(y, "int8_rescale"):
            return int8_rescale_plain(y, sx, w_scale, out_dtype, bias)
        M, N, (vec, threads) = _rescale_args(y, sx, w_scale, out_dtype, bias)
        out = y.new_empty(y.shape, dtype=out_dtype)
        if M == 0:
            return out
        fn = _kernel("int8_rescale")
        stream = _stream(y)
        with annotate("int8_rescale", launch=True):
            rc = fn(_DTYPES[out_dtype], vec, threads, y.data_ptr(), sx.data_ptr(),
                    w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, N, stream)
        if rc != 0:
            raise RuntimeError(f"int8_rescale: kernel launch failed (cudaError {rc})")
        int8_rescale.launches += 1
        return out


quant_act.launches = 0
int8_rescale.launches = 0
