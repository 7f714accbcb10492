"""Swin window attention and the whole eval Swin block (kernels K3 and K5).

The counterpart of the JAX package's ``ops/window_attn.py``, forward only,
with its signatures. Layout: ``x`` is ``[B, H, W, C]``; weights are flax
``Dense`` kernels ``[in, out]``; ``bias`` is ``build_window_bias``'s
``[nH, nW, h, N, N]`` fp32 (relative-position bias plus shift mask, in the
rolled window frame).

- ``window_attention_plain`` (counterpart of ``_reference_window_attention``):
  cyclic shift by ``-shift``, window partition, per-head attention with the
  additive bias, window reverse, shift back.
- ``swin_block_plain`` (counterpart of ``_reference_swin_block``): LN1 ->
  window attention -> residual -> LN2 -> fc1 -> exact-erf GELU -> fc2 ->
  residual.
- ``fused_window_attention`` wraps K5 and ``fused_swin_block`` wraps K3, both
  ``csrc/window_attn.cu`` (one source, MLP switched at compile time). They
  replace the Pallas TPU kernels ``_kernel`` (K5) and ``_block_kernel`` (K3)
  of ``zs_aac_tpu/ops/window_attn.py``. K3 loops over the hidden dimension
  in chunks, so it also computes ``_block_kernel_stream``'s function (K4) at
  stage-4 shapes. For CPU tensors the wrappers call the plain versions; for
  CUDA tensors they launch or raise. ``.launches`` counts launches.

Numerics (the exact-GELU twins of the JAX package): in the activation dtype
``dt`` these round to ``dt`` -- qkv, q times the (``dt``-rounded) scale,
the probabilities, the attention output o, the projection, the LN outputs,
the residual sums, the GELU output and z. Scores, softmax, LN statistics and
every matmul accumulator stay fp32. LN uses biased variance.
"""

from __future__ import annotations

import ctypes

import torch

from zs_aac_tpu_torch.utils.cuda_build import load_library

__all__ = [
    "build_window_bias",
    "window_attention_plain",
    "swin_block_plain",
    "fused_window_attention",
    "fused_swin_block",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 64     # the kernel's per-head buffers are sized for d <= 64
_MAX_TOKENS = 64       # tokens per window (N = window**2)
_HIDDEN_CHUNK = 64     # hidden columns per MLP chunk (kChunk in the kernel)


def build_window_bias(rpb, mask, nH: int, nW: int):
    """Per-window additive bias: ``rpb`` [h, N, N] plus the shift ``mask``
    [nH*nW, N, N] (or None) -> [nH, nW, h, N, N] fp32 (window id i*nW + j,
    the rolled-frame partition order)."""
    h, N, _ = rpb.shape
    b = rpb.float()[None, None].expand(nH, nW, h, N, N)
    if mask is not None:
        b = b + torch.as_tensor(mask, device=rpb.device).float().reshape(nH, nW, 1, N, N)
    return b.contiguous()


def _round(t, dt):
    """Round a float tensor through ``dt`` (the identity for fp32)."""
    return t.to(dt).float()


def _ln(x, scale, bias, eps):
    """LayerNorm over channels, fp32 statistics, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _window_partition(x, window):
    """[B, H, W, C] -> [B*nW, window*window, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, C)


def _window_reverse(x, window, H, W):
    """[B*nW, window*window, C] -> [B, H, W, C]."""
    B = x.shape[0] // ((H // window) * (W // window))
    x = x.reshape(B, H // window, W // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                           num_heads: int, shift: int):
    """Plain PyTorch version of K5. ``x`` [B, H, W, C] -> same shape."""
    B, H, W, C = x.shape
    dt = x.dtype
    w, h = window, num_heads
    N, d = w * w, C // h
    nH, nW = H // w, W // w
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = _window_partition(x, w)                                     # [B_, N, C]
    qkv = _round(xw.float() @ qkv_w.float() + qkv_b.float(), dt)
    q, k, v = qkv.reshape(-1, N, 3, h, d).permute(2, 0, 3, 1, 4)
    scale = _round(torch.tensor(float(d) ** -0.5), dt).item()
    q = _round(q * scale, dt)
    att = (q @ k.transpose(-1, -2)).reshape(B, nH * nW, h, N, N)
    att = att + bias.float().reshape(1, nH * nW, h, N, N)
    p = _round(torch.softmax(att, dim=-1), dt).reshape(-1, h, N, N)
    o = _round(p @ v, dt).transpose(1, 2).reshape(-1, N, C)
    out = (o @ proj_w.float() + proj_b.float()).to(dt)
    out = _window_reverse(out, w, H, W)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out


def swin_block_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                     fc1_w, fc1_b, fc2_w, fc2_b, bias, window: int, num_heads: int,
                     shift: int, eps: float):
    """Plain PyTorch version of K3. ``x`` [B, H, W, C] -> same shape."""
    dt = x.dtype
    o = window_attention_plain(_ln(x, ln1_s, ln1_b, eps), qkv_w, qkv_b, proj_w, proj_b,
                               bias, window, num_heads, shift)
    y = (x.float() + o.float()).to(dt)
    yn = _ln(y, ln2_s, ln2_b, eps)
    hmid = torch.nn.functional.gelu(yn.float() @ fc1_w.float() + fc1_b.float()).to(dt)
    z = (hmid.float() @ fc2_w.float() + fc2_b.float()).to(dt)
    return (y.float() + z.float()).to(dt)


def _lib():
    lib = load_library("window_attn")
    if lib.swin_window.argtypes is None:
        lib.swin_window.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 15
                                    + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                                    + [ctypes.c_void_p])
        lib.swin_window.restype = ctypes.c_int
        lib.swin_window_smem.argtypes = [ctypes.c_int] * 6
        lib.swin_window_smem.restype = ctypes.c_int
        lib.swin_window_smem_limit.argtypes = []
        lib.swin_window_smem_limit.restype = ctypes.c_int
    return lib


def _pick_rows(lib, itemsize: int, N: int, C: int, d: int, mlp: bool):
    """Rows per MLP pass (the largest multiple-of-8 divisor of N whose
    shared memory fits; N itself without an MLP) and the launch's bytes of
    shared memory. Raises where even the attention phase does not fit."""
    limit = lib.swin_window_smem_limit()
    for rows in ([r for r in range(N, 0, -8) if N % r == 0] if mlp else [N]):
        smem = lib.swin_window_smem(itemsize, int(mlp), N, C, d, rows)
        if smem <= limit:
            return rows, smem
    raise ValueError(f"window attention: N={N}, C={C}, head dim {d} in "
                     f"{itemsize}-byte floats needs more than the card's {limit} "
                     "bytes of shared memory per block")


def _launch(name, mlp, x, qkv_w, qkv_b, proj_w, proj_b, bias, window, num_heads, shift,
            ln=None, mlp_w=None, eps=0.0):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"{name}: unsupported activation dtype {dt}")
    w = window
    if w <= 0 or H % w or W % w:
        raise ValueError(f"{name}: {H}x{W} is not a grid of {w}x{w} windows")
    N = w * w
    if N % 8 or N > _MAX_TOKENS:
        raise ValueError(f"{name}: {N} tokens per window; the kernel takes a "
                         f"multiple of 8 up to {_MAX_TOKENS}")
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"{name}: {C} channels do not split into {num_heads} heads")
    d = C // num_heads
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {_MAX_HEAD_DIM}")
    if not 0 <= shift < min(H, W):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(H, W)})")
    nH, nW = H // w, W // w
    hidden = mlp_w[0].shape[1] if mlp else 0
    shapes = [("qkv_w", qkv_w, (C, 3 * C), dt), ("qkv_b", qkv_b, (3 * C,), dt),
              ("proj_w", proj_w, (C, C), dt), ("proj_b", proj_b, (C,), dt),
              ("bias", bias, (nH, nW, num_heads, N, N), torch.float32)]
    if mlp:
        shapes += [(n, t, (C,), dt) for n, t in zip(("ln1_s", "ln1_b", "ln2_s", "ln2_b"), ln)]
        shapes += [("fc1_w", mlp_w[0], (C, hidden), dt), ("fc1_b", mlp_w[1], (hidden,), dt),
                   ("fc2_w", mlp_w[2], (hidden, C), dt), ("fc2_b", mlp_w[3], (C,), dt)]
    for n, t, shape, tdt in [("x", x, (B, H, W, C), dt)] + shapes:
        if tuple(t.shape) != shape or t.dtype != tdt or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {tdt} tensor of shape "
                             f"{shape}, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    lib = _lib()
    rows, _ = _pick_rows(lib, x.element_size(), N, C, d, mlp)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    ln1_s, ln1_b, ln2_s, ln2_b = ln if mlp else (None,) * 4
    fc1_w, fc1_b, fc2_w, fc2_b = mlp_w if mlp else (None,) * 4
    scale = float(torch.tensor(float(d) ** -0.5).to(dt).item())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.swin_window(
        _DTYPES[dt], int(mlp), x.data_ptr(), out.data_ptr(), ptr(ln1_s), ptr(ln1_b),
        qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
        ptr(ln2_s), ptr(ln2_b), ptr(fc1_w), ptr(fc1_b), ptr(fc2_w), ptr(fc2_b),
        bias.data_ptr(), B, H, W, C, num_heads, w, shift, hidden, rows, _HIDDEN_CHUNK,
        float(eps), scale, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    return out


def fused_window_attention(x, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                           num_heads: int, shift: int):
    """K5: ``window_attention_plain`` for CPU tensors, the CUDA kernel for
    CUDA tensors (same arguments and result)."""
    if x.device.type == "cpu":
        return window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, window,
                                      num_heads, shift)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_window_attention: no kernel for device {x.device}")
    out = _launch("fused_window_attention", False, x, qkv_w, qkv_b, proj_w, proj_b,
                  bias, window, num_heads, shift)
    fused_window_attention.launches += 1
    return out


def fused_swin_block(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                     fc1_w, fc1_b, fc2_w, fc2_b, bias, window: int, num_heads: int,
                     shift: int, eps: float):
    """K3: ``swin_block_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors (same arguments and result)."""
    if x.device.type == "cpu":
        return swin_block_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s,
                                ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, bias, window,
                                num_heads, shift, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_swin_block: no kernel for device {x.device}")
    out = _launch("fused_swin_block", True, x, qkv_w, qkv_b, proj_w, proj_b, bias,
                  window, num_heads, shift, ln=(ln1_s, ln1_b, ln2_s, ln2_b),
                  mlp_w=(fc1_w, fc1_b, fc2_w, fc2_b), eps=eps)
    fused_swin_block.launches += 1
    return out


fused_window_attention.launches = 0
fused_swin_block.launches = 0
