"""SpecAugment: train-time time and frequency stripe masking.

The counterpart of the JAX package's ``ops/specaug.py`` (torchlibrosa's
``SpecAugmentation`` as the reference encoders use it): per example,
``stripes_num`` stripes per axis, each with a width drawn uniformly from
``[0, drop_width)`` and a start uniform in ``[0, max(size - width, 1))``, are
zeroed. Defaults: time 64 x 2, frequency 8 x 2. The draws come from the
``torch.Generator`` the caller passes (on its own device), so a seed
reproduces the masks; they are not the JAX package's bits.
"""

from __future__ import annotations

import torch

__all__ = ["spec_augment", "stripe_mask"]


def stripe_mask(widths, starts, size: int):
    """Keep-mask [b, size] from stripe ``widths`` and ``starts`` [b, n]:
    False inside any stripe (``_stripe_mask``'s interval formula)."""
    pos = torch.arange(size, device=widths.device)[None, None, :]
    inside = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return ~inside.any(dim=1)


def _draw(generator, b: int, size: int, drop_width: int, n_stripes: int):
    """Widths uniform in [0, drop_width) and starts uniform in [0, max(size -
    width, 1)), each [b, n_stripes] int64 on the generator's device."""
    dev = generator.device
    widths = torch.randint(0, drop_width, (b, n_stripes), generator=generator, device=dev)
    high = torch.clamp(size - widths, min=1)
    u = torch.rand(b, n_stripes, generator=generator, device=dev, dtype=torch.float64)
    starts = torch.minimum((u * high).long(), high - 1)
    return widths, starts


def spec_augment(x, generator: torch.Generator, *, time_drop_width: int = 64,
                 time_stripes_num: int = 2, freq_drop_width: int = 8,
                 freq_stripes_num: int = 2, data=None):
    """Apply SpecAugment to a spectrogram batch ``[B, 1, T, F]`` (or ``[B, T,
    F]``); returns a tensor of the same shape and dtype. Under ``data`` (a
    ``parallel.mesh.Axis``; ``x`` this rank's rows) the stripes are drawn
    for the global batch and this rank keeps its rows' draws, so any world
    size masks each row as one process does."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, None]
    b, _, t, f = x.shape
    n = b * (data.size if data else 1)
    local = data.local if data else (lambda v: v)
    tw, ts = map(local, _draw(generator, n, t, time_drop_width, time_stripes_num))
    fw, fs = map(local, _draw(generator, n, f, freq_drop_width, freq_stripes_num))
    tmask = stripe_mask(tw, ts, t).to(x.device)
    fmask = stripe_mask(fw, fs, f).to(x.device)
    out = x * tmask[:, None, :, None].to(x.dtype) * fmask[:, None, None, :].to(x.dtype)
    return out[:, 0] if squeeze else out
