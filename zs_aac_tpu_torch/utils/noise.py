"""Embedding noise injection: the modality-gap trick the captioner trains with.

The counterpart of the JAX package's ``utils/noise.py``: normalize, add
Gaussian (or uniform-ball) noise of the given variance, normalize again. The
draws come from the caller's ``torch.Generator`` (on the input's device), so a
seed gives one result; they are not ``jax.random``'s draws. With variance 0
the input comes back unchanged.
"""

from __future__ import annotations

import math

import torch

__all__ = ["noise_injection", "get_uniform_ball_noise"]


def _normalize(x):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


def get_uniform_ball_noise(shape, radius: float = 0.1, generator=None):
    """Points drawn uniformly from the ball of ``radius`` in ``shape[1]``
    dimensions, one per row: [shape[0], shape[1]] fp32 on the generator's
    device."""
    dev = generator.device if generator is not None else None
    sphere = _normalize(torch.randn(shape, generator=generator, device=dev))
    u = torch.rand(shape[0], generator=generator, device=dev) ** (1.0 / shape[1])
    return sphere * (u * radius)[:, None]


def noise_injection(x: torch.Tensor, variance: float = 0.001, uniform_noise: bool = False,
                    dont_norm: bool = False, generator=None, data=None) -> torch.Tensor:
    """``x`` [B, E] normalized (unless ``dont_norm``), plus noise of
    ``variance``, normalized again. Under ``data`` (``parallel.mesh.Axis``;
    ``x`` this rank's rows) the noise is drawn for the global batch and this
    rank keeps its rows, as one process would draw them."""
    if variance == 0.0:
        return x
    std = math.sqrt(variance)
    if not dont_norm:
        x = _normalize(x)
    shape = (x.shape[0] * (data.size if data else 1), *x.shape[1:])
    local = data.local if data else (lambda v: v)
    if uniform_noise:
        x = x + local(get_uniform_ball_noise(shape, radius=std, generator=generator)).to(x)
    else:
        x = x + local(torch.randn(shape, generator=generator, device=x.device,
                                  dtype=x.dtype)) * std
    return _normalize(x)
