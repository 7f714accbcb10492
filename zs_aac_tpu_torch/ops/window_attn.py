"""Swin window attention and the whole Swin block, eval and train (kernels
K3, K5, K6, K7, K8 and K9).

The counterpart of the JAX package's ``ops/window_attn.py``, with its
signatures. Layout: ``x`` is ``[B, H, W, C]``; weights are flax ``Dense``
kernels ``[in, out]``; ``bias`` is ``build_window_bias``'s ``[nH, nW, h, N,
N]`` fp32 (relative-position bias plus shift mask, in the rolled window
frame); ``m1``/``m2`` are per-sample drop-path keep scales ``[B]`` fp32.

Plain PyTorch versions (the CPU route and the kernels' yardsticks):

- ``window_attention_plain`` (``_reference_window_attention``): cyclic shift
  by ``-shift``, window partition, per-head attention with the additive
  bias, window reverse, shift back; ``window_attention_bwd_plain``
  (``_fused_window_attention_bwd``) its backward.
- ``swin_block_plain`` (``_reference_swin_block``): LN1 -> window attention
  -> residual -> LN2 -> fc1 -> exact-erf GELU -> fc2 -> residual.
- ``swin_block_train_plain`` (``_reference_swin_block_train``): the same
  with ``y = x + m1 * attn`` and ``out = y + m2 * z``, returning ``(out,
  y)``; its backward in two halves, ``mlp_bwd_plain`` (``_mlp_bwd_call``:
  LN2/MLP from the saved ``y``) then ``attn_ln1_bwd_plain``
  (``_attn_ln1_bwd_call``: LN1/attention from ``x``).

Differentiable wrappers (``torch.autograd.Function``s), each routing CPU
tensors to the plain versions and CUDA tensors to the kernels (raising on
what a kernel refuses, never falling back):

- ``fused_window_attention``: forward K5, backward K6
  (``window_attention_bwd``);
- ``fused_swin_block``: forward K3, backward the autograd of
  ``swin_block_plain`` (the JAX ``_fsb_bwd``);
- ``fused_swin_block_train``: forward K7, backward K8 (``mlp_bwd``) then K9
  (``attn_ln1_bwd``); zero cotangents for ``m1``/``m2``.

K3, K5 and K7 are ``csrc/window_attn.cu``, in two instantiations chosen by
shape (``window_kernel_plan``): tensor-core kernels for bf16 at HTSAT's
shapes, the FMA kernel for fp32 and every other shape. K6, K8 and K9 are
``csrc/swin_train.cu``. Each kernel's wrapper counts its launches in
``.launches``, and K3/K5/K7's those that took the tensor-core kernels in
``.tc_launches``.

Numerics (the JAX kernels' rounding points): in the activation dtype ``dt``
these round -- qkv, q times the (``dt``-rounded) scale, the probabilities,
o, the projection, the LN outputs (and the LN parameters, as the kernels
read them), the residual sums, ``m * branch``, the GELU output and z; in the
backward go, do, dq (then dq * scale), dk, dv, dxn, gz, dh1 and dx. Scores,
softmax, ds, dp, LN statistics and every matmul or gradient sum stay fp32.
GELU and its derivative are exact. LN uses biased variance.
"""

from __future__ import annotations

import ctypes
import math

import torch

from zs_aac_tpu_torch.utils.cuda_build import load_library

__all__ = [
    "build_window_bias",
    "window_attention_plain",
    "window_attention_bwd_plain",
    "swin_block_plain",
    "swin_block_train_plain",
    "mlp_bwd_plain",
    "attn_ln1_bwd_plain",
    "fused_window_attention",
    "fused_swin_block",
    "fused_swin_block_train",
    "window_attention_bwd",
    "mlp_bwd",
    "attn_ln1_bwd",
    "window_kernel_plan",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 64     # the kernel's per-head buffers are sized for d <= 64
_MAX_TOKENS = 64       # tokens per window (N = window**2)
_HIDDEN_CHUNK = 64     # hidden columns per MLP chunk (kChunk in the kernel)
_WGRAD_BLOCKS = 528    # split-token weight-gradient blocks to aim for (4 per SM)
_TC_HEAD_DIM = 24      # the tensor-core kernels' head dim (every HTSAT stage)
_TC_GROUP = 96         # channels per warp column group there: 4 heads


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


def _ln_parts(x, scale, bias, eps):
    """LayerNorm as the train kernels compute it, parameters rounded to x's
    dtype: (out in x's dtype, xhat fp32, 1/sigma fp32)."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mean) * inv
    return (xhat * _round(scale, dt) + _round(bias, dt)).to(dt), xhat, inv


def _ln_bwd(dout, xhat, inv, scale, dt):
    """LayerNorm backward (the JAX ``_ln_bwd_f32``): (du fp32, dscale, dbias
    summed over every row)."""
    g = dout.float()
    gs = g * _round(scale, dt)
    du = (gs - gs.mean(-1, keepdim=True) - xhat * (gs * xhat).mean(-1, keepdim=True)) * inv
    rows = tuple(range(g.dim() - 1))
    return du, (g * xhat).sum(rows), g.sum(rows)


def _gelu_grad(h):
    """d/dh of the exact GELU: Phi(h) + h phi(h)."""
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * torch.exp(-0.5 * h * h) \
        * 0.3989422804014327


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


def _to_windows(t, window, shift):
    if shift:
        t = torch.roll(t, (-shift, -shift), dims=(1, 2))
    return _window_partition(t, window)


def _from_windows(t, window, H, W, shift):
    t = _window_reverse(t, window, H, W)
    if shift:
        t = torch.roll(t, (shift, shift), dims=(1, 2))
    return t


def _scale(d, dt) -> float:
    """The attention scale d**-0.5, rounded to ``dt`` as the kernels take it."""
    return float(torch.tensor(float(d) ** -0.5).to(dt).item())


def window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                           num_heads: int, shift: int):
    """Plain PyTorch version of K5. ``x`` [B, H, W, C] -> same shape."""
    B, H, W, C = x.shape
    dt = x.dtype
    w, h = window, num_heads
    N, d = w * w, C // h
    nH, nW = H // w, W // w
    xw = _to_windows(x, w, shift)                                    # [B_, N, C]
    qkv = _round(xw.float() @ qkv_w.float() + qkv_b.float(), dt)
    q, k, v = qkv.reshape(-1, N, 3, h, d).permute(2, 0, 3, 1, 4)
    q = _round(q * _scale(d, dt), dt)
    att = (q @ k.transpose(-1, -2)).reshape(B, nH * nW, h, N, N)
    att = att + bias.float().reshape(1, nH * nW, h, N, N)
    p = _round(torch.softmax(att, dim=-1), dt).reshape(-1, h, N, N)
    o = _round(p @ v, dt).transpose(1, 2).reshape(-1, N, C)
    out = (o @ proj_w.float() + proj_b.float()).to(dt)
    return _from_windows(out, w, H, W, shift)


def _attn_bwd_windows(xw, gw, qkv_w, qkv_b, proj_w, bias, B, h):
    """The attention backward on windows (the JAX ``_bwd_kernel`` math per
    head): ``xw`` the windows' input and ``gw`` the output cotangent, both
    [B*nWin, N, C] in ``dt``. Returns dxw [B*nWin, N, C] in ``dt`` and the
    fp32 gradients dqkv_w, dqkv_b, dproj_w, dproj_b, dbias [nWin, h, N, N]."""
    dt = xw.dtype
    Bw, N, C = xw.shape
    d = C // h
    nWin = Bw // B
    scale = _scale(d, dt)
    qkv = _round(xw.float() @ qkv_w.float() + qkv_b.float(), dt)
    q, k, v = qkv.reshape(Bw, N, 3, h, d).permute(2, 0, 3, 1, 4)     # [Bw, h, N, d]
    qs = _round(q * scale, dt)
    s = (qs @ k.transpose(-1, -2)).reshape(B, nWin, h, N, N) + bias.float().reshape(
        1, nWin, h, N, N)
    p = torch.softmax(s, dim=-1).reshape(Bw, h, N, N)
    pdt = _round(p, dt)
    o = _round(pdt @ v, dt).transpose(1, 2).reshape(Bw * N, C)
    g2 = gw.float().reshape(Bw * N, C)
    do = _round(g2 @ proj_w.float().t(), dt).reshape(Bw, N, h, d).transpose(1, 2)
    dproj_w = o.t() @ g2
    dproj_b = g2.sum(0)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_dt = _round(ds, dt)
    dq = _round(_round(ds_dt @ k, dt) * scale, dt)
    dk = _round(ds_dt.transpose(-1, -2) @ qs, dt)
    dv = _round(pdt.transpose(-1, -2) @ do, dt)
    dqkv = torch.stack([dq, dk, dv], 1).permute(0, 3, 1, 2, 4).reshape(Bw * N, 3 * C)
    dxw = (dqkv @ qkv_w.float().t()).to(dt).reshape(Bw, N, C)
    dqkv_w = xw.float().reshape(Bw * N, C).t() @ dqkv
    dbias = ds.reshape(B, nWin, h, N, N).sum(0)
    return dxw, dqkv_w, dqkv.sum(0), dproj_w, dproj_b, dbias


def window_attention_bwd_plain(x, g, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                               num_heads: int, shift: int):
    """Plain PyTorch version of K6: the backward of ``window_attention_plain``
    at ``x`` for the output cotangent ``g`` -> (dx, dqkv_w, dqkv_b, dproj_w,
    dproj_b, dbias), each in its primal's dtype."""
    B, H, W, C = x.shape
    nH, nW, N = H // window, W // window, window * window
    dxw, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias = _attn_bwd_windows(
        _to_windows(x, window, shift), _to_windows(g.to(x.dtype), window, shift), qkv_w, qkv_b,
        proj_w, bias, B, num_heads)
    return (_from_windows(dxw, window, H, W, shift), dqkv_w.to(qkv_w.dtype),
            dqkv_b.to(qkv_b.dtype), dproj_w.to(proj_w.dtype), dproj_b.to(proj_b.dtype),
            dbias.reshape(nH, nW, num_heads, N, N).to(bias.dtype))


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


def _keep(m, dt):
    """Per-sample keep scales [B] -> [B, 1, 1, 1] fp32, rounded to ``dt``."""
    return _round(m.float(), dt)[:, None, None, None]


def swin_block_train_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                           fc1_w, fc1_b, fc2_w, fc2_b, bias, m1, m2, window: int,
                           num_heads: int, shift: int, eps: float):
    """Plain PyTorch version of K7: the train block with drop-path keep
    scales ``m1``/``m2`` [B] -> ``(out, y)``, ``y = x + m1 * attn`` the
    post-attention residual."""
    dt = x.dtype
    xn = _ln_parts(x, ln1_s, ln1_b, eps)[0]
    o = window_attention_plain(xn, qkv_w, qkv_b, proj_w, proj_b, bias, window, num_heads,
                               shift)
    y = (x.float() + _round(_keep(m1, dt) * o.float(), dt)).to(dt)
    yn = _ln_parts(y, ln2_s, ln2_b, eps)[0]
    hmid = torch.nn.functional.gelu(yn.float() @ fc1_w.float() + fc1_b.float()).to(dt)
    z = _round(hmid.float() @ fc2_w.float() + fc2_b.float(), dt)
    return (y.float() + _round(_keep(m2, dt) * z, dt)).to(dt), y


def mlp_bwd_plain(y, g, m2, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, eps: float):
    """Plain PyTorch version of K8: from the saved residual ``y`` and the
    block's output cotangent ``g`` -> (dy = g + m2-scaled MLP backward,
    dln2_s, dln2_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b), gradients fp32."""
    dt = y.dtype
    C = y.shape[-1]
    hidden = fc1_w.shape[1]
    yn, yhat, inv = _ln_parts(y, ln2_s, ln2_b, eps)
    ynf = yn.float().reshape(-1, C)
    hmid = ynf @ fc1_w.float() + fc1_b.float()
    hg = _round(torch.nn.functional.gelu(hmid), dt)
    gz = _round(g.float() * m2.float()[:, None, None, None], dt).reshape(-1, C)
    dh1 = (gz @ fc2_w.float().t()) * _gelu_grad(hmid)
    dh1_dt = _round(dh1, dt)
    dyn = (dh1_dt @ fc1_w.float().t()).reshape(y.shape)
    du, dln2_s, dln2_b = _ln_bwd(dyn, yhat, inv, ln2_s, dt)
    dy = (g.float() + _round(du, dt)).to(dt)
    return (dy, dln2_s, dln2_b, ynf.t() @ dh1_dt, dh1.sum(0), hg.reshape(-1, hidden).t() @ gz,
            gz.sum(0))


def attn_ln1_bwd_plain(x, dy, m1, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, bias, window: int,
                       num_heads: int, shift: int, eps: float):
    """Plain PyTorch version of K9: from ``x`` and the residual's total
    cotangent ``dy`` -> (dx = dy + LN1/attention backward of m1 * dy,
    dln1_s, dln1_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias), gradients
    fp32."""
    dt = x.dtype
    B, H, W, C = x.shape
    nH, nW, N = H // window, W // window, window * window
    xn, xhat, inv = _ln_parts(x, ln1_s, ln1_b, eps)
    go = (dy.float() * _keep(m1, dt)).to(dt)
    dxw, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias = _attn_bwd_windows(
        _to_windows(xn, window, shift), _to_windows(go, window, shift), qkv_w, qkv_b, proj_w,
        bias, B, num_heads)
    du, dln1_s, dln1_b = _ln_bwd(_from_windows(dxw, window, H, W, shift), xhat, inv, ln1_s, dt)
    dx = (dy.float() + _round(du, dt)).to(dt)
    return (dx, dln1_s, dln1_b, dqkv_w, dqkv_b, dproj_w, dproj_b,
            dbias.reshape(nH, nW, num_heads, N, N))


# -- the CUDA kernels ------------------------------------------------------------


def _route(x, name) -> bool:
    """True for CPU tensors (the plain version), False for CUDA ones (the
    kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return False


def _lib():
    lib = load_library("window_attn")
    if lib.swin_window.argtypes is None:
        lib.swin_window.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 15
                                    + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                                    + [ctypes.c_void_p] * 4)
        lib.swin_window.restype = ctypes.c_int
        lib.swin_window_tc.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                                       + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                                       + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
        lib.swin_window_tc.restype = ctypes.c_int
        lib.swin_window_smem.argtypes = [ctypes.c_int] * 6
        lib.swin_window_smem.restype = ctypes.c_int
        lib.swin_window_smem_limit.argtypes = []
        lib.swin_window_smem_limit.restype = ctypes.c_int
    return lib


def _train_lib():
    lib = load_library("swin_train")
    if lib.swin_attn_bwd.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.swin_train_smem.argtypes = [i] * 6
        lib.swin_train_smem_limit.argtypes = []
        lib.swin_attn_bwd.argtypes = [i, i] + [vp] * 17 + [i] * 8 + [f, f, vp]
        lib.swin_mlp_bwd.argtypes = ([i] + [vp] * 15 + [ctypes.c_longlong] + [i] * 4
                                     + [f, vp])
        lib.swin_wgrad.argtypes = [i, vp, i, vp, i, ctypes.c_longlong, i, i, i, vp, vp, vp]
        lib.swin_reduce.argtypes = [vp, i, ctypes.c_longlong, vp, vp]
        for fn in (lib.swin_train_smem, lib.swin_train_smem_limit, lib.swin_attn_bwd,
                   lib.swin_mlp_bwd, lib.swin_wgrad, lib.swin_reduce):
            fn.restype = ctypes.c_int
    return lib


def _check_window(name, dtype, N: int, d: int):
    """What every window kernel (FMA, tensor-core, backward) asks of the
    dtype, the tokens per window and the head dim; raises otherwise."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported activation dtype {dtype}")
    if N % 8 or N > _MAX_TOKENS:
        raise ValueError(f"{name}: {N} tokens per window; the kernel takes a "
                         f"multiple of 8 up to {_MAX_TOKENS}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {_MAX_HEAD_DIM}")


def window_kernel_plan(dtype, N: int, C: int, d: int, hidden=None):
    """Which instantiation of ``csrc/window_attn.cu`` a launch of K3, K5 or K7
    takes, from the activation dtype, the tokens per window ``N``, the
    channels ``C``, the head dim ``d`` and, with an MLP, its hidden width.

    - ``("tc", wpb, split)``: the tensor-core kernels. bf16, N = 64 (8x8
      windows), d = 24 and C = 96, 192, 384 or 768 (HTSAT's four stages), the
      hidden width a multiple of 64 per 96 channels in flight. ``wpb`` is
      the windows per block (2 at C <= 192, else 1); ``split`` is true at C =
      768, where the heads and the output columns of one window are split
      over two blocks in a chain of kernels.
    - ``("fma",)``: the FMA kernel. fp32 always (TF32 would break the fp32
      fixtures' tolerances), and bf16 at any other shape it takes: N a
      multiple of 8 up to 64, d up to 64 (and enough shared memory, which
      only the card can say: ``_pick_rows`` raises there).

    Raises ``TypeError`` or ``ValueError`` for what neither takes. A rule on
    shapes alone: a CUDA tensor launches the planned kernel or raises."""
    _check_window("window attention", dtype, N, d)
    groups = C // _TC_GROUP
    if (dtype == torch.bfloat16 and N == 64 and d == _TC_HEAD_DIM and C % _TC_GROUP == 0
            and groups in (1, 2, 4, 8)
            and (hidden is None or hidden % (64 * min(groups, 4)) == 0)):
        return ("tc", 2 if groups <= 2 else 1, groups == 8)
    return ("fma",)


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


def _check(name, tensors, dev):
    """Each (label, tensor, shape, dtype): contiguous, of that shape and
    dtype, on ``dev``; raises otherwise."""
    for n, t, shape, tdt in tensors:
        if tuple(t.shape) != tuple(shape) or t.dtype != tdt or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous {tdt} tensor of shape "
                             f"{tuple(shape)}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")


def _geometry(name, x, window, num_heads, shift):
    """(B, H, W, C, N, d) of a launch; raises on what the kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    w = window
    if w <= 0 or H % w or W % w:
        raise ValueError(f"{name}: {H}x{W} is not a grid of {w}x{w} windows")
    N = w * w
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"{name}: {C} channels do not split into {num_heads} heads")
    d = C // num_heads
    _check_window(name, x.dtype, N, d)
    if not 0 <= shift < min(H, W):
        raise ValueError(f"{name}: shift {shift} outside [0, {min(H, W)})")
    return B, H, W, C, N, d


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(fn, mlp, x, qkv_w, qkv_b, proj_w, proj_b, bias, window, num_heads, shift,
            ln=None, mlp_w=None, eps=0.0, keep=None):
    """Launch K5 (no MLP), K3 (MLP) or K7 (MLP and ``keep`` = (m1, m2)) for the
    wrapper ``fn``, whose counts it raises: returns ``out`` (and ``y`` for
    K7)."""
    name = fn.__name__
    B, H, W, C, N, d = _geometry(name, x, window, num_heads, shift)
    dt = x.dtype
    nH, nW = H // window, W // window
    hidden = mlp_w[0].shape[1] if mlp else 0
    shapes = [("x", x, (B, H, W, C), dt), ("qkv_w", qkv_w, (C, 3 * C), dt),
              ("qkv_b", qkv_b, (3 * C,), dt), ("proj_w", proj_w, (C, C), dt),
              ("proj_b", proj_b, (C,), dt),
              ("bias", bias, (nH, nW, num_heads, N, N), torch.float32)]
    if mlp:
        shapes += [(n, t, (C,), dt) for n, t in zip(("ln1_s", "ln1_b", "ln2_s", "ln2_b"), ln)]
        shapes += [("fc1_w", mlp_w[0], (C, hidden), dt), ("fc1_b", mlp_w[1], (hidden,), dt),
                   ("fc2_w", mlp_w[2], (hidden, C), dt), ("fc2_b", mlp_w[3], (C,), dt)]
    if keep is not None:
        shapes += [(n, t, (B,), torch.float32) for n, t in zip(("m1", "m2"), keep)]
    _check(name, shapes, x.device)
    plan = window_kernel_plan(dt, N, C, d, hidden if mlp else None)
    lib = _lib()
    out = torch.empty_like(x)
    y = torch.empty_like(x) if keep is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    ln1_s, ln1_b, ln2_s, ln2_b = ln if mlp else (None,) * 4
    fc1_w, fc1_b, fc2_w, fc2_b = mlp_w if mlp else (None,) * 4
    m1, m2 = keep if keep is not None else (None, None)
    weights = (ptr(ln1_s), ptr(ln1_b), qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(),
               proj_b.data_ptr(), ptr(ln2_s), ptr(ln2_b), ptr(fc1_w), ptr(fc1_b), ptr(fc2_w),
               ptr(fc2_b), bias.data_ptr())
    if plan[0] == "tc":
        _, wpb, split = plan
        for n, t, _, _ in shapes:
            if t.data_ptr() % 16:   # 16-byte vector loads and cp.async
                raise ValueError(f"{name}: {n} must be 16-byte aligned")
        # split: o passes through a window-major scratch and the residual
        # through y (a scratch of its own outside train mode)
        scratch = torch.empty_like(x) if split else None
        y_buf = torch.empty_like(x) if split and mlp and y is None else y
        rc = lib.swin_window_tc(
            int(mlp), x.data_ptr(), out.data_ptr(), *weights, B, H, W, C, num_heads, window,
            shift, hidden, float(eps), _scale(d, dt), ptr(y_buf), ptr(m1), ptr(m2),
            ptr(scratch), wpb, _stream(x))
    else:
        rows, _ = _pick_rows(lib, x.element_size(), N, C, d, mlp)
        rc = lib.swin_window(
            _DTYPES[dt], int(mlp), x.data_ptr(), out.data_ptr(), *weights, B, H, W, C,
            num_heads, window, shift, hidden, rows, _HIDDEN_CHUNK, float(eps), _scale(d, dt),
            ptr(y), ptr(m1), ptr(m2), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    fn.launches += 1
    fn.tc_launches += plan[0] == "tc"
    return out if keep is None else (out, y)


def _train_rows(name, lib, which, itemsize, C, candidates):
    """The largest of ``candidates`` whose shared memory fits; raises if none."""
    limit = lib.swin_train_smem_limit()
    for rows in candidates:
        if lib.swin_train_smem(which, itemsize, 0, C, 0, rows) <= limit:
            return rows
    raise ValueError(f"{name}: C={C} needs more than the card's {limit} bytes of shared "
                     "memory per block")


def _wgrad(lib, name, A, lda, B, ldb, n_tok, M, Ncol):
    """[M, Ncol] fp32 = A^T B over ``n_tok`` rows (A None: the column sums
    of B, [1, Ncol]) through the split-token kernel of ``swin_train.cu``."""
    tiles = math.ceil(M / 64) * math.ceil(Ncol / 64)
    n_chunks = max(1, min(math.ceil(_WGRAD_BLOCKS / tiles), n_tok // 256))
    part = torch.empty(n_chunks * M * Ncol, dtype=torch.float32, device=B.device)
    out = torch.empty(M, Ncol, dtype=torch.float32, device=B.device)
    rc = lib.swin_wgrad(_DTYPES[B.dtype], None if A is None else A.data_ptr(), lda,
                        B.data_ptr(), ldb, n_tok, M, Ncol, n_chunks, part.data_ptr(),
                        out.data_ptr(), _stream(B))
    if rc != 0:
        raise RuntimeError(f"{name}: weight-gradient launch failed (cudaError {rc})")
    return out


def _reduce(lib, name, part):
    """Sum of ``part`` [n, len] over its first axis, in a fixed order."""
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    rc = lib.swin_reduce(part.data_ptr(), part.shape[0], part.shape[1], out.data_ptr(),
                         _stream(part))
    if rc != 0:
        raise RuntimeError(f"{name}: reduction launch failed (cudaError {rc})")
    return out


def _attn_bwd_launch(name, x, g, m1, ln, qkv_w, qkv_b, proj_w, bias, window, num_heads,
                     shift, eps):
    """K6 (``ln`` None) or K9 (``ln`` = (ln1_s, ln1_b), ``g`` = dy, ``m1``):
    (dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias[, dln1_s, dln1_b]), the
    gradients fp32."""
    B, H, W, C, N, d = _geometry(name, x, window, num_heads, shift)
    dt = x.dtype
    h = num_heads
    nH, nW = H // window, W // window
    if d % 8:
        raise ValueError(f"{name}: head dim {d} is not a multiple of 8")
    shapes = [("x", x, (B, H, W, C), dt), ("g", g, (B, H, W, C), dt),
              ("qkv_w", qkv_w, (C, 3 * C), dt), ("qkv_b", qkv_b, (3 * C,), dt),
              ("proj_w", proj_w, (C, C), dt),
              ("bias", bias, (nH, nW, h, N, N), torch.float32)]
    if ln is not None:
        shapes += [("ln1_s", ln[0], (C,), dt), ("ln1_b", ln[1], (C,), dt),
                   ("m1", m1, (B,), torch.float32)]
    _check(name, shapes, x.device)
    lib = _train_lib()
    limit = lib.swin_train_smem_limit()
    if lib.swin_train_smem(0, x.element_size(), N, C, d, 0) > limit:
        raise ValueError(f"{name}: N={N}, C={C}, head dim {d} in {x.element_size()}-byte "
                         f"floats needs more than the card's {limit} bytes of shared memory "
                         "per block")
    rows = _train_rows(name, lib, 1, x.element_size(), C,
                       [r for r in range(N, 0, -8) if N % r == 0])
    n_tok = B * H * W
    new = lambda *s, dtype=dt: torch.empty(*s, dtype=dtype, device=x.device)
    dx = torch.empty_like(x)
    xn_s, go_s, o_s, do_s = (new(n_tok, C) for _ in range(4))
    dqkv_s = new(n_tok, 3 * C)
    dbias_part = new(B, nH * nW * h * N * N, dtype=torch.float32)
    ln_part = new(n_tok // rows if ln is not None else 1, 2 * C, dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.swin_attn_bwd(
        _DTYPES[dt], int(ln is not None), x.data_ptr(), g.data_ptr(), ptr(m1),
        ptr(ln[0] if ln else None), ptr(ln[1] if ln else None), qkv_w.data_ptr(),
        qkv_b.data_ptr(), proj_w.data_ptr(), bias.data_ptr(), dx.data_ptr(), xn_s.data_ptr(),
        go_s.data_ptr(), o_s.data_ptr(), do_s.data_ptr(), dqkv_s.data_ptr(),
        dbias_part.data_ptr(), ln_part.data_ptr(), B, H, W, C, h, window, shift, rows,
        float(eps), _scale(d, dt), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    grads = (dx, _wgrad(lib, name, xn_s, C, dqkv_s, 3 * C, n_tok, C, 3 * C),
             _wgrad(lib, name, None, 0, dqkv_s, 3 * C, n_tok, 1, 3 * C).reshape(-1),
             _wgrad(lib, name, o_s, C, go_s, C, n_tok, C, C),
             _wgrad(lib, name, None, 0, go_s, C, n_tok, 1, C).reshape(-1),
             _reduce(lib, name, dbias_part).reshape(nH, nW, h, N, N))
    if ln is None:
        return grads
    sums = _reduce(lib, name, ln_part)
    return grads + (sums[:C], sums[C:])


def _mlp_bwd_launch(name, y, g, m2, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, eps):
    """K8: (dy, dln2_s, dln2_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b), gradients fp32."""
    if y.dim() != 4 or y.dtype not in _DTYPES:
        raise ValueError(f"{name}: y must be a [B, H, W, C] fp32 or bf16 tensor")
    B, H, W, C = y.shape
    dt = y.dtype
    hidden = fc1_w.shape[1] if fc1_w.dim() == 2 else -1
    _check(name, [("y", y, (B, H, W, C), dt), ("g", g, (B, H, W, C), dt),
                  ("m2", m2, (B,), torch.float32), ("ln2_s", ln2_s, (C,), dt),
                  ("ln2_b", ln2_b, (C,), dt), ("fc1_w", fc1_w, (C, hidden), dt),
                  ("fc1_b", fc1_b, (hidden,), dt), ("fc2_w", fc2_w, (hidden, C), dt)],
           y.device)
    n_tok = B * H * W
    lib = _train_lib()
    rows = _train_rows(name, lib, 2, y.element_size(), C,
                       [r for r in (64, 32, 16, 8) if n_tok % r == 0])
    new = lambda *s, dtype=dt: torch.empty(*s, dtype=dtype, device=y.device)
    dy = torch.empty_like(y)
    yn_s, gz_s = new(n_tok, C), new(n_tok, C)
    hg_s, dh1_s = new(n_tok, hidden), new(n_tok, hidden)
    ln_part = new(n_tok // rows, 2 * C, dtype=torch.float32)
    fc1b_part = new(n_tok // rows, hidden, dtype=torch.float32)
    rc = lib.swin_mlp_bwd(
        _DTYPES[dt], y.data_ptr(), g.data_ptr(), m2.data_ptr(), ln2_s.data_ptr(),
        ln2_b.data_ptr(), fc1_w.data_ptr(), fc1_b.data_ptr(), fc2_w.data_ptr(), dy.data_ptr(),
        yn_s.data_ptr(), gz_s.data_ptr(), hg_s.data_ptr(), dh1_s.data_ptr(),
        ln_part.data_ptr(), fc1b_part.data_ptr(), n_tok, H * W, C, hidden, rows, float(eps),
        _stream(y))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    sums = _reduce(lib, name, ln_part)
    return (dy, sums[:C], sums[C:],
            _wgrad(lib, name, yn_s, C, dh1_s, hidden, n_tok, C, hidden),
            _reduce(lib, name, fc1b_part),
            _wgrad(lib, name, hg_s, hidden, gz_s, C, n_tok, hidden, C),
            _wgrad(lib, name, None, 0, gz_s, C, n_tok, 1, C).reshape(-1))


# -- wrappers of the backward kernels -------------------------------------------


def window_attention_bwd(x, g, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                         num_heads: int, shift: int):
    """K6: ``window_attention_bwd_plain`` for CPU tensors, the CUDA kernel for
    CUDA tensors (same arguments and result)."""
    if _route(x, "window_attention_bwd"):
        return window_attention_bwd_plain(x, g, qkv_w, qkv_b, proj_w, proj_b, bias, window,
                                          num_heads, shift)
    dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias = _attn_bwd_launch(
        "window_attention_bwd", x, g.contiguous(), None, None, qkv_w, qkv_b, proj_w, bias,
        window, num_heads, shift, 0.0)
    window_attention_bwd.launches += 1
    return (dx, dqkv_w.to(qkv_w.dtype), dqkv_b.to(qkv_b.dtype), dproj_w.to(proj_w.dtype),
            dproj_b.to(proj_b.dtype), dbias)


def mlp_bwd(y, g, m2, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, eps: float):
    """K8: ``mlp_bwd_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors (same arguments and result)."""
    if _route(y, "mlp_bwd"):
        return mlp_bwd_plain(y, g, m2, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, eps)
    out = _mlp_bwd_launch("mlp_bwd", y, g.contiguous(), m2, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w,
                          eps)
    mlp_bwd.launches += 1
    return out


def attn_ln1_bwd(x, dy, m1, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, bias, window: int,
                 num_heads: int, shift: int, eps: float):
    """K9: ``attn_ln1_bwd_plain`` for CPU tensors, the CUDA kernel for CUDA
    tensors (same arguments and result)."""
    if _route(x, "attn_ln1_bwd"):
        return attn_ln1_bwd_plain(x, dy, m1, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, bias, window,
                                  num_heads, shift, eps)
    dx, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias, dln1_s, dln1_b = _attn_bwd_launch(
        "attn_ln1_bwd", x, dy.contiguous(), m1, (ln1_s, ln1_b), qkv_w, qkv_b, proj_w, bias,
        window, num_heads, shift, eps)
    attn_ln1_bwd.launches += 1
    return dx, dln1_s, dln1_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias


# -- differentiable wrappers --------------------------------------------------------


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, bias, window, num_heads, shift):
        if _route(x, "fused_window_attention"):
            out = window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, bias, window,
                                         num_heads, shift)
        else:
            out = _launch(fused_window_attention, False, x, qkv_w, qkv_b, proj_w, proj_b,
                          bias, window, num_heads, shift)
        ctx.save_for_backward(x, qkv_w, qkv_b, proj_w, proj_b, bias)
        ctx.cfg = (window, num_heads, shift)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        return (*window_attention_bwd(x, g, *weights, *ctx.cfg), None, None, None)


class _SwinBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *args):
        weights, cfg = args[:13], args[13:]
        if _route(x, "fused_swin_block"):
            out = swin_block_plain(x, *weights, *cfg)
        else:
            (ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
             fc1_w, fc1_b, fc2_w, fc2_b, bias) = weights
            out = _launch(fused_swin_block, True, x, qkv_w, qkv_b, proj_w, proj_b, bias,
                          *cfg[:3], ln=(ln1_s, ln1_b, ln2_s, ln2_b),
                          mlp_w=(fc1_w, fc1_b, fc2_w, fc2_b), eps=cfg[3])
        ctx.save_for_backward(x, *weights)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = swin_block_plain(*inputs, *ctx.cfg)
        grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        return (*grads, None, None, None, None)


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b, fc1_w, fc1_b,
                fc2_w, fc2_b, bias, m1, m2, window, num_heads, shift, eps):
        dt = x.dtype
        if _route(x, "fused_swin_block_train"):
            out, y = swin_block_train_plain(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b,
                                            ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, bias, m1,
                                            m2, window, num_heads, shift, eps)
        else:
            w = lambda t: t.to(dt).contiguous()
            out, y = _launch(fused_swin_block_train, True, x, w(qkv_w), w(qkv_b), w(proj_w),
                             w(proj_b), bias, window, num_heads, shift,
                             ln=tuple(map(w, (ln1_s, ln1_b, ln2_s, ln2_b))),
                             mlp_w=tuple(map(w, (fc1_w, fc1_b, fc2_w, fc2_b))), eps=eps,
                             keep=(m1.float().contiguous(), m2.float().contiguous()))
        ctx.save_for_backward(x, y, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, ln2_s, ln2_b, fc1_w,
                              fc1_b, fc2_w, bias, m1, m2)
        ctx.cfg = (window, num_heads, shift, eps)
        ctx.dtypes = (proj_b.dtype, fc2_b.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, y, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, bias,
         m1, m2) = ctx.saved_tensors
        window, num_heads, shift, eps = ctx.cfg
        dt = x.dtype
        g = g.to(dt).contiguous()
        w = (lambda t: t) if x.device.type == "cpu" else (lambda t: t.to(dt).contiguous())
        keep = lambda m: m.float().contiguous()
        dy, dln2_s, dln2_b, dfc1_w, dfc1_b, dfc2_w, dfc2_b = mlp_bwd(
            y, g, keep(m2), w(ln2_s), w(ln2_b), w(fc1_w), w(fc1_b), w(fc2_w), eps)
        dx, dln1_s, dln1_b, dqkv_w, dqkv_b, dproj_w, dproj_b, dbias = attn_ln1_bwd(
            x, dy, keep(m1), w(ln1_s), w(ln1_b), w(qkv_w), w(qkv_b), w(proj_w), bias, window,
            num_heads, shift, eps)
        like = lambda grad, t: grad.to(t.dtype)
        return (dx, like(dln1_s, ln1_s), like(dln1_b, ln1_b), like(dqkv_w, qkv_w),
                like(dqkv_b, qkv_b), like(dproj_w, proj_w), dproj_b.to(ctx.dtypes[0]),
                like(dln2_s, ln2_s), like(dln2_b, ln2_b), like(dfc1_w, fc1_w),
                like(dfc1_b, fc1_b), like(dfc2_w, fc2_w), dfc2_b.to(ctx.dtypes[1]),
                like(dbias, bias), torch.zeros_like(m1), torch.zeros_like(m2),
                None, None, None, None)


def fused_window_attention(x, qkv_w, qkv_b, proj_w, proj_b, bias, window: int,
                           num_heads: int, shift: int):
    """K5 forward, K6 backward: ``window_attention_plain`` (and its backward)
    for CPU tensors, the CUDA kernels for CUDA tensors."""
    return _WindowAttention.apply(x, qkv_w, qkv_b, proj_w, proj_b, bias, window, num_heads,
                                  shift)


def fused_swin_block(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                     fc1_w, fc1_b, fc2_w, fc2_b, bias, window: int, num_heads: int,
                     shift: int, eps: float):
    """K3 forward: ``swin_block_plain`` for CPU tensors, the CUDA kernel for
    CUDA tensors; the backward is the autograd of ``swin_block_plain``."""
    return _SwinBlock.apply(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                            fc1_w, fc1_b, fc2_w, fc2_b, bias, window, num_heads, shift, eps)


def fused_swin_block_train(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                           fc1_w, fc1_b, fc2_w, fc2_b, bias, m1, m2, window: int,
                           num_heads: int, shift: int, eps: float):
    """The train block: K7 forward, K8 then K9 backward (the plain versions
    for CPU tensors). Returns ``out``; the LN parameters may be fp32 (the
    kernels read them rounded to x's dtype, and their gradients come back in
    their own dtype)."""
    return _SwinBlockTrain.apply(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                                 fc1_w, fc1_b, fc2_w, fc2_b, bias, m1, m2, window, num_heads,
                                 shift, eps)


for _fn in (fused_window_attention, fused_swin_block, fused_swin_block_train,
            window_attention_bwd, mlp_bwd, attn_ln1_bwd):
    _fn.launches = 0
for _fn in (fused_window_attention, fused_swin_block, fused_swin_block_train):
    _fn.tc_launches = 0
