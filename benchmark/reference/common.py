"""Pieces the plain references share: seeded weights in a few large draws,
symmetric integer quantization, and the precision switches.

Plain PyTorch only: nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run seeded with ``seed``
    (weights, inputs, the check's sample), within torch's 64-bit range."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919) % (1 << 62)


def strict_fp32() -> None:
    """float32 matmuls and convolutions in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def seeded_leaves(specs: Sequence[Tuple[str, Tuple[int, ...], float, float]], seed: int,
                  device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Leaves ``name -> mean + std * N(0, 1)`` of the given shapes, all from
    one draw of a ``torch.Generator`` on ``device`` seeded with ``seed``, in
    ``dtype``. Each leaf is a contiguous view of the one buffer."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, mean, std in specs:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        if std != 1.0:
            leaf.mul_(std)
        if mean != 0.0:
            leaf.add_(mean)
        out[name] = leaf
        off += n
    return out


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """An IEEE division by a constant (a Python scalar would become a
    multiplication by its reciprocal on CUDA)."""
    return x / torch.tensor(float(c), dtype=x.dtype, device=x.device)


def quant_rows(x: torch.Tensor, bits: int):
    """Symmetric per-row quantization over the last axis: (integer values
    as floats, scale [..., 1]). scale = max(amax / qmax, 1e-8)."""
    s = torch.clamp_min(div(x.abs().amax(dim=-1, keepdim=True), qmax(bits)), 1e-8)
    return torch.clamp(torch.round(x / s), -qmax(bits), qmax(bits)), s


def quant_cols(w: torch.Tensor, bits: int):
    """Symmetric per-output-column quantization of a weight [in, out]:
    (integer values as floats [in, out], scale [out]). scale = max(amax,
    1e-8) / qmax."""
    w = w.float()
    s = div(torch.clamp_min(w.abs().amax(dim=0), 1e-8), qmax(bits))
    return torch.clamp(torch.round(w / s), -qmax(bits), qmax(bits)), s


def qmatmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, bits: int) -> torch.Tensor:
    """W8A8 (or WnAn) product: per-row quantized activations times the
    quantized weight, then both scales."""
    xq, sx = quant_rows(x, bits)
    return (xq @ wq) * sx * ws
