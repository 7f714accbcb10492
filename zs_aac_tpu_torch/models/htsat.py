"""HTSAT, the hierarchical token-semantic audio transformer (Swin).

The counterpart of the JAX package's ``models/htsat.py``: the log-mel
spectrogram is folded into a ``spec_size`` square image (the time axis
resized by a precomputed bicubic matrix), patch-embedded 4x4, run through
the Swin stages (shifted windows on odd blocks, relative-position bias,
patch merging), normalized, regrouped over frequency, and averaged into the
``embedding``; ``return_dict`` adds the token-semantic conv head's outputs.

Parameters are the JAX variable tree as tensors (``{"params",
"batch_stats"}``; Dense kernels ``[in, out]``, conv kernels HWIO, LayerNorm
``scale``/``bias``), so ``models.convert.from_jax_params`` is a leaf-wise
copy. ``fused_block`` and ``fused_attn`` keep the JAX meaning (True/False or
a tuple of stage indices): a block of a ``fused_block`` stage is kernel K3
(``ops.window_attn.fused_swin_block``); otherwise its attention is kernel K5
(``fused_window_attention``) where ``fused_attn`` holds, else the plain
version, and its LN/MLP are PyTorch ops. K3 takes every stage in bf16; a
shape whose shared memory it cannot hold (fp32 at C=768) raises on the card.

``apply(..., train=True, generator=g)`` is the train mode and returns
``(output, new_batch_stats)``: ``bn0`` normalizes with the batch's fp32
statistics (flax's biased variance, E[x^2] - E[x]^2) and updates the running
ones as ``0.9 * old + 0.1 * batch``; spec augmentation follows it; each block
draws per-sample drop-path keep scales ``m1``, ``m2`` = bernoulli(keep) /
keep (rates ``linspace(0, drop_path_rate, n_blocks)``, no draw at rate 0).
A ``fused_block`` stage then runs the train kernels (K7 forward, K8 and K9
backward, ``ops.window_attn.fused_swin_block_train``); the layered path
scales its two branches by the same ``m1``/``m2``, with K5 forward and K6
backward as its attention where ``fused_attn`` holds. Every random draw
comes from ``g``, in one order whatever the dispatch, so one seed gives every
dispatch the same masks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.cnns import batch_norm
from zs_aac_tpu_torch.models.gpt2 import _ln
from zs_aac_tpu_torch.ops.specaug import spec_augment
from zs_aac_tpu_torch.ops.window_attn import (_window_partition, _window_reverse,  # noqa: F401
                                              build_window_bias, fused_swin_block,
                                              fused_swin_block_train, fused_window_attention,
                                              window_attention_plain)
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["HTSAT", "bicubic_resize_matrix", "drop_path_scale"]

_LN_EPS = 1e-6


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """PyTorch's bicubic convolution kernel (Keys, a=-0.75)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=8)
def bicubic_resize_matrix(t_in: int, t_out: int) -> np.ndarray:
    """[t_in, t_out] weights of a 1-D bicubic resize with align_corners=True."""
    if t_in == t_out:
        return np.eye(t_in, dtype=np.float32)
    scale = (t_in - 1) / (t_out - 1)
    w = np.zeros((t_in, t_out), np.float64)
    for o in range(t_out):
        src = o * scale
        base = int(np.floor(src))
        for k in range(-1, 3):
            idx = min(max(base + k, 0), t_in - 1)
            w[idx, o] += _cubic_kernel(np.array(src - (base + k)))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)  # [wh*ww, wh*ww]


@functools.lru_cache(maxsize=32)
def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> Optional[np.ndarray]:
    """[nW, win*win, win*win] additive mask (0 / -100) of shifted windows."""
    if shift == 0:
        return None
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = (img.reshape(h // window, window, w // window, window)
           .transpose(0, 2, 1, 3).reshape(-1, window * window))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def drop_path_scale(u, keep: float):
    """Per-sample drop-path keep scales from uniforms ``u`` in [0, 1):
    bernoulli(keep) / keep, the bernoulli being ``u < keep``."""
    return (u < keep).float() / keep


def _dense(x, p, dt):
    """flax ``nn.Dense(dtype=dt)``: x and the kernel in ``dt``, bias added."""
    y = x.to(dt) @ p["kernel"].to(dt)
    return y + p["bias"].to(dt) if "bias" in p else y


def _window_attention(p, res, heads, window, shift, dt):
    """``_WindowAttention``'s parameters in the kernels' form (the JAX
    ``return_raw``): qkv/proj weights in ``dt`` and the per-window bias
    (the relative-position table gathered, plus the shift mask)."""
    H, W = res
    N = window * window
    table = p["rpb_table"]
    idx = torch.from_numpy(_relative_position_index(window, window).reshape(-1)).to(table.device)
    rpb = table[idx].reshape(N, N, heads).permute(2, 0, 1)
    bias = build_window_bias(rpb, _shift_attn_mask(H, W, window, shift), H // window, W // window)
    w = lambda t: t.to(dt).contiguous()
    return (w(p["qkv"]["kernel"]), w(p["qkv"]["bias"]), w(p["proj"]["kernel"]),
            w(p["proj"]["bias"]), bias)


def _swin_block(p, x, res, heads, window, shift, dt, fused_attn, fused_block, train=False,
                keep=None):
    """``_SwinBlock``: for a ``fused_block`` stage kernel K3 (eval) or the
    train kernels K7/K8/K9 (``train``); else LN1 -> window attention (K5/K6
    where ``fused_attn``, else the plain version) -> residual -> LN2 -> fc1
    -> GELU -> fc2 -> residual. ``keep`` = (m1, m2), the drop-path keep
    scales of the two branches ([B] fp32), or None."""
    H, W = res
    B, L, C = x.shape
    attn = _window_attention(p["attn"], res, heads, window, shift, dt)
    w = lambda t: t.to(dt).contiguous()
    if fused_block and train:
        m1, m2 = keep if keep is not None else (torch.ones(B, device=x.device),) * 2
        out = fused_swin_block_train(
            x.reshape(B, H, W, C).to(dt).contiguous(), p["norm1"]["scale"],
            p["norm1"]["bias"], *attn[:4], p["norm2"]["scale"], p["norm2"]["bias"],
            w(p["fc1"]["kernel"]), w(p["fc1"]["bias"]), w(p["fc2"]["kernel"]),
            w(p["fc2"]["bias"]), attn[4], m1, m2, window, heads, shift, _LN_EPS)
        return out.reshape(B, L, C)
    if fused_block:
        out = fused_swin_block(
            x.reshape(B, H, W, C).to(dt).contiguous(), w(p["norm1"]["scale"]),
            w(p["norm1"]["bias"]), *attn[:4], w(p["norm2"]["scale"]), w(p["norm2"]["bias"]),
            w(p["fc1"]["kernel"]), w(p["fc1"]["bias"]), w(p["fc2"]["kernel"]),
            w(p["fc2"]["bias"]), attn[4], window, heads, shift, _LN_EPS)
        return out.reshape(B, L, C)
    m1, m2 = keep if keep is not None else (None, None)
    scaled = lambda t, m: t if m is None else t * m.to(t.dtype)[:, None, None]
    h = _ln(x, p["norm1"], _LN_EPS).reshape(B, H, W, C).to(dt).contiguous()
    attend = fused_window_attention if fused_attn else window_attention_plain
    x = x + scaled(attend(h, *attn, window, heads, shift).reshape(B, L, C), m1)
    h = _dense(_ln(x, p["norm2"], _LN_EPS), p["fc1"], dt)
    return x + scaled(_dense(F.gelu(h), p["fc2"], dt), m2)


def _patch_merging(p, x, res, dt):
    """``_PatchMerging``: 2x2 neighbours concatenated (in the reference's
    order), LayerNorm, a bias-free reduction to 2C."""
    H, W = res
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(B, -1, 4 * C)
    return _dense(_ln(x, p["norm"], _LN_EPS), p["reduction"], dt)


@dataclasses.dataclass(frozen=True)
class HTSAT:
    """Swin audio encoder: ``apply(variables, spec [B, T, F]) -> [B, C_out]``."""

    spec_size: int = 256
    patch_stride: int = 4
    patch_size: int = 4
    num_classes: int = 527
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    n_mels: int = 64
    spec_augmentation: bool = True
    fused_attn: Any = False
    fused_block: Any = False
    dtype: Any = torch.float32

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.n_mels

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    def _stage_fused(self, i: int, attr) -> bool:
        if isinstance(attr, (tuple, list, frozenset, set)):
            return i in attr
        return bool(attr)

    def _stages(self):
        """(stage, block, dim, heads, resolution, window, shift) per block."""
        res = (self.spec_size // self.patch_stride, self.spec_size // self.patch_stride)
        for i, depth in enumerate(self.depths):
            dim = int(self.embed_dim * 2**i)
            for j in range(depth):
                window = self.window_size
                shift = 0 if j % 2 == 0 else self.window_size // 2
                if min(res) <= window:
                    shift, window = 0, min(res)
                yield i, j, dim, self.num_heads[i], res, window, shift
            res = (res[0] // 2, res[1] // 2) if i < len(self.depths) - 1 else res

    # -- parameters ---------------------------------------------------------

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Seeded random variables in the JAX tree layout (flax's initializers:
        LeCun-normal kernels, zero biases, unit LayerNorm/BatchNorm scales,
        relative-position tables N(0, 0.02))."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)

        def normal(shape, std):
            return (torch.randn(shape, generator=g) * std).to(dev)

        def dense(din, dout, bias=True):
            p = {"kernel": normal((din, dout), din ** -0.5)}
            if bias:
                p["bias"] = torch.zeros(dout, device=dev)
            return p

        def ln(d):
            return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

        ps, ed = self.patch_size, self.embed_dim
        params = {
            "bn0": ln(self.n_mels),
            "patch_proj": {"kernel": normal((ps, ps, 1, ed), (ps * ps) ** -0.5),
                           "bias": torch.zeros(ed, device=dev)},
            "patch_norm": ln(ed),
        }
        for i, j, dim, heads, res, window, shift in self._stages():
            hidden = int(dim * self.mlp_ratio)
            params[f"layer{i}_block{j}"] = {
                "norm1": ln(dim), "norm2": ln(dim),
                "attn": {"qkv": dense(dim, 3 * dim), "proj": dense(dim, dim),
                         "rpb_table": normal(((2 * window - 1) ** 2, heads), 0.02)},
                "fc1": dense(dim, hidden), "fc2": dense(hidden, dim),
            }
            if j == self.depths[i] - 1 and i < len(self.depths) - 1:
                params[f"downsample{i}"] = {"norm": ln(4 * dim),
                                            "reduction": dense(4 * dim, 2 * dim, bias=False)}
        nf = self.num_features
        params["norm"] = ln(nf)
        cfb = self._final_resolution()[0] // self.freq_ratio
        params["tscam_conv"] = {"kernel": normal((cfb, 3, nf, self.num_classes),
                                                 (cfb * 3 * nf) ** -0.5),
                                "bias": torch.zeros(self.num_classes, device=dev)}
        stats = {"bn0": {"mean": torch.zeros(self.n_mels, device=dev),
                         "var": torch.ones(self.n_mels, device=dev)}}
        return {"params": params, "batch_stats": stats}

    def _final_resolution(self):
        r = self.spec_size // self.patch_stride // 2 ** (len(self.depths) - 1)
        return r, r

    # -- forward ------------------------------------------------------------

    def _reshape_wav2img(self, x):
        """[B, T, F] -> [B, spec_size, spec_size] (the reference's
        reshape_wav2img): bicubic resize to the target size, then time folded
        into ``freq_ratio`` chunks stacked along frequency."""
        B, T, Fq = x.shape
        target_T = self.spec_size * self.freq_ratio
        target_F = self.spec_size // self.freq_ratio
        if T > target_T or Fq > target_F:
            raise ValueError(f"spectrogram {T}x{Fq} larger than the Swin input "
                             f"{target_T}x{target_F}")
        x = x.float()
        if T < target_T:
            m = torch.from_numpy(bicubic_resize_matrix(T, target_T)).to(x.device)
            x = torch.einsum("btf,to->bof", x, m)
        if Fq < target_F:
            m = torch.from_numpy(bicubic_resize_matrix(Fq, target_F)).to(x.device)
            x = torch.einsum("btf,fo->bto", x, m)
        fr = self.freq_ratio
        x = x.transpose(1, 2).reshape(B, target_F, fr, target_T // fr)
        return x.transpose(1, 2).reshape(B, fr * target_F, target_T // fr)

    def _bn0(self, bn, stats, spec, train: bool, data=None):
        """``bn0`` over the mel bins (``models.cnns.batch_norm``, flax's):
        running statistics in eval; in train the batch's (the global
        batch's under ``data``) and the updated running statistics."""
        y, new = batch_norm(spec, bn, stats, train, axis=-1, data=data)
        return y.to(self.dtype), ({"bn0": new} if train else None)

    def _keep_scales(self, generator, B: int, device, data=None):
        """Per block: (m1, m2) drop-path keep scales [B] fp32, or None at rate
        0; under ``data`` drawn for the global batch, this rank's rows kept."""
        n = B * (data.size if data else 1)
        local = data.local if data else (lambda v: v)
        rates = np.linspace(0, self.drop_path_rate, sum(self.depths))
        out = []
        for rate in rates:
            if rate == 0.0:
                out.append(None)
                continue
            keep = 1.0 - float(rate)
            draw = lambda: drop_path_scale(
                local(torch.rand(n, generator=generator, device=generator.device)),
                keep).to(device)
            m1 = draw()
            out.append((m1, draw()))
        return out

    def apply(self, variables, spec, *, train: bool = False, return_dict: bool = False,
              generator: Optional[torch.Generator] = None, data=None):
        """``spec`` [B, T, F] log-mel -> the embedding [B, C_out] (or the dict
        of ``embedding``, ``fine_grained_embedding``, ``framewise_output``,
        ``clipwise_output`` with ``return_dict``). With ``train`` it returns
        ``(that, new_batch_stats)`` and takes its random draws (spec
        augmentation, drop path) from ``generator``. Under ``data``
        (``parallel.mesh.Axis``) ``spec`` is this rank's rows: ``bn0``'s
        statistics are the global batch's and the draws are made for the
        global batch and sliced."""
        p, st = variables["params"], variables["batch_stats"]
        dt = self.dtype
        with annotate("encode.frontend"):
            x, new_stats = self._bn0(p["bn0"], st["bn0"], spec, train, data)
        keeps = [None] * sum(self.depths)
        if train:
            needs_draws = self.spec_augmentation or self.drop_path_rate > 0
            if needs_draws and generator is None:
                raise ValueError("HTSAT train mode with spec augmentation or drop path "
                                 "needs a torch.Generator")
            if self.spec_augmentation:
                x = spec_augment(x, generator, data=data)
            if self.drop_path_rate > 0:
                keeps = self._keep_scales(generator, x.shape[0], x.device, data)
        with annotate("encode.frontend"):
            x = self._reshape_wav2img(x)                           # [B, S, S] fp32
        B, S, _ = x.shape
        ps, stride = self.patch_size, self.patch_stride
        if ps != stride:
            raise ValueError("HTSAT: overlapping patches (patch_size != patch_stride)")
        Hp, Wp = S // ps, S // ps
        patches = (x[:, : Hp * ps, : Wp * ps].reshape(B, Hp, ps, Wp, ps)
                   .permute(0, 1, 3, 2, 4).reshape(B, Hp * Wp, ps * ps))
        proj = p["patch_proj"]
        x = _dense(patches, {"kernel": proj["kernel"].reshape(ps * ps, -1),
                             "bias": proj["bias"]}, dt)                # conv k=s=ps
        x = _ln(x, p["patch_norm"], _LN_EPS)

        for k, (i, j, dim, heads, res, window, shift) in enumerate(self._stages()):
            x = _swin_block(p[f"layer{i}_block{j}"], x, res, heads, window, shift, dt,
                            self._stage_fused(i, self.fused_attn),
                            self._stage_fused(i, self.fused_block), train, keeps[k])
            if j == self.depths[i] - 1 and i < len(self.depths) - 1:
                x = _patch_merging(p[f"downsample{i}"], x, res, dt)

        x = _ln(x, p["norm"], _LN_EPS)                             # [B, SF*ST, C]
        SF, ST = self._final_resolution()
        C = x.shape[-1]
        x = x.transpose(1, 2).reshape(B, C, SF, ST)
        fr = self.freq_ratio
        cfb = SF // fr
        x = x.reshape(B, C, SF // cfb, cfb, ST).permute(0, 1, 3, 2, 4).reshape(B, C, cfb, -1)
        embedding = x.reshape(B, C, -1).mean(dim=-1)
        if not return_dict:
            return (embedding, new_stats) if train else embedding

        rep = 8 * self.patch_stride
        fine = torch.repeat_interleave(x.mean(dim=2).transpose(1, 2), rep, dim=1)
        tc = p["tscam_conv"]
        weight = tc["kernel"].to(dt).permute(3, 2, 0, 1)            # HWIO -> OIHW
        logits = F.conv2d(x.to(dt), weight, tc["bias"].to(dt), padding=(0, 1))
        logits = logits[:, :, 0].transpose(1, 2)                    # [B, T', classes]
        framewise = torch.repeat_interleave(torch.sigmoid(logits), rep, dim=1)
        clipwise = torch.sigmoid(logits.mean(dim=1))
        out = {"embedding": embedding, "fine_grained_embedding": fine,
               "framewise_output": framewise, "clipwise_output": clipwise}
        return (out, new_stats) if train else out
