"""On-device polyphase Kaiser-sinc resampling as one matmul.

The counterpart of the JAX package's ``ops/resample.py`` (which has no
kernel: the resample is a framing and one matmul, and stays one here).
Same filter as the host resampler (``native/audioio.cpp::resample_sinc``):
32-tap Kaiser-windowed sinc (beta 8.6, HALF=16), per-phase weight
normalization, and the host path's edge renormalization reproduced by a
precomputed per-output correction vector.

For a reduced ratio ``sr_out/sr_in = L/M`` the output is made in blocks of
L samples; block ``b`` reads the input window ``x[b*M - 15 : b*M + M + 16]``
(length ``F = M + 31``), so the resample is ``frames [K, F] @ W [F, L]`` per
clip, with the frames built from shifted views of one reshape. This lets the
bank build ship int16 PCM at the file's native rate and resample on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["poly_resample_plan", "resample_poly_device"]

_HALF = 16
_TAPS = 2 * _HALF  # k in [-HALF+1, HALF]
_BETA = 8.6


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    s = np.ones_like(x)
    t = np.ones_like(x)
    for k in range(1, 32):
        t = t * (x / (2.0 * k)) ** 2
        s = s + t
    return s


def _tap_weight(d: np.ndarray, cutoff: float) -> np.ndarray:
    """Kaiser-windowed sinc weight at distance d (the host's tap_weight)."""
    t = d / _HALF
    inside = np.abs(t) <= 1.0
    sinc = np.where(d == 0.0, 1.0,
                    np.sin(np.pi * cutoff * d) / np.where(d == 0.0, 1.0,
                                                          np.pi * cutoff * d))
    win = _bessel_i0(_BETA * np.sqrt(np.clip(1.0 - t * t, 0.0, None)))
    win = win / _bessel_i0(np.asarray(_BETA))
    return np.where(inside, cutoff * sinc * win, 0.0)


@functools.lru_cache(maxsize=16)
def poly_resample_plan(sr_in: int, sr_out: int, n_in: int):
    """The block-polyphase plan for a fixed input length:
    ``(W [F, L] f32, corr [n_out] f32, M, L, F, n_out)`` with
    ``y[b*L + p] = sum_j frames[b, j] * W[j, p]``, ``frames[b] =
    x_pad[b*M : b*M + F]`` (x left-padded by HALF-1 zeros), times ``corr``
    (full-window weight sum over the in-range partial sum at the edges)."""
    if sr_in == sr_out:
        raise ValueError("poly_resample_plan: sr_in == sr_out needs no plan")
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    cutoff = sr_out / sr_in if sr_out < sr_in else 1.0
    n_out = int(n_in * sr_out // sr_in)

    ks = np.arange(-_HALF + 1, _HALF + 1, dtype=np.float64)  # [TAPS]
    fracs = (np.arange(L, dtype=np.float64) * M % L) / L     # phase of row p
    offs = (np.arange(L) * M) // L                           # base offset of row p
    w = _tap_weight(fracs[:, None] - ks[None, :], cutoff)    # [L, TAPS]
    wsum = w.sum(axis=1, keepdims=True)
    wn = w / wsum

    Fw = M + _TAPS - 1
    W = np.zeros((Fw, L), np.float64)
    for p in range(L):
        j0 = int(offs[p])
        W[j0 : j0 + _TAPS, p] += wn[p]

    corr = np.ones(n_out, np.float64)
    for o in list(range(min(n_out, 2 * _HALF * L // M + 2))) + list(
        range(max(0, n_out - 2 * _HALF * L // M - 2), n_out)
    ):
        p = o % L
        base = (o * M) // L
        idx = base + ks
        valid = (idx >= 0) & (idx < n_in)
        psum = w[p][valid].sum()
        if psum > 0 and psum != wsum[p, 0]:
            corr[o] = wsum[p, 0] / psum
    return (W.astype(np.float32), corr.astype(np.float32), M, L, Fw, n_out)


def resample_poly_device(x: torch.Tensor, sr_in: int, sr_out: int,
                         target_len: int | None = None) -> torch.Tensor:
    """[B, n_in] int16 PCM or float at sr_in -> [B, n_out] float32 at sr_out
    on x's device; ``target_len`` zero-pads or truncates the output. Span
    ``encode.frontend``."""
    with annotate("encode.frontend"):
        return _resample(x, sr_in, sr_out, target_len)


def _resample(x, sr_in, sr_out, target_len):
    B, n_in = x.shape
    if x.dtype == torch.int16:
        x = x.float() / 32768.0
    else:
        x = x.float()
    if sr_in == sr_out:
        y = x
    else:
        W, corr, M, L, Fw, n_out = poly_resample_plan(sr_in, sr_out, n_in)
        K = -(-n_out // L)  # blocks
        nc = -(-Fw // M)
        pad_r = (K + nc) * M - (_HALF - 1) - n_in
        xp = F.pad(x, (_HALF - 1, max(pad_r, 0)))
        c = xp[:, : (K + nc) * M].reshape(B, K + nc, M)
        frames = torch.cat([c[:, i : i + K] for i in range(nc)], dim=-1)[:, :, :Fw]
        Wt = torch.from_numpy(W).to(x.device)
        y = torch.matmul(frames, Wt)                       # [B, K, L], fp32
        y = y.reshape(B, K * L)[:, :n_out] * torch.from_numpy(corr).to(x.device)
    if target_len is not None:
        n = y.shape[1]
        y = y[:, :target_len] if n >= target_len else F.pad(y, (0, target_len - n))
    return y
