"""Symmetric int8 quantization helpers shared by the model and kernel K1.

The operation order is that of the JAX package (``models/gpt2.py``
``_quant_act`` and ``_quantize_vec``): abs-max, ``/ 127``, ``max(., 1e-8)``,
a true division ``x / scale``, round half to even, clip to +-127. Every
division here is by a tensor: on CUDA, PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal, which can differ in the last
bit and change an int8 value.
"""

from __future__ import annotations

import functools

import torch

from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["div", "quantize_vec", "quant_act"]


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


def quant_act(x: torch.Tensor):
    """Dynamic per-row int8 activation quantization: (int8 [..., K],
    fp32 scale [..., 1]). The abs-max reduces in ``x``'s own dtype, which
    is exact. Span ``layer.quant``."""
    with annotate("layer.quant"):
        sx = torch.clamp_min(div(x.abs().amax(dim=-1, keepdim=True).float(), 127.0),
                             1e-8)
        xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    return xq, sx
