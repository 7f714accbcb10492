"""Type aliases and the device-picking helper (the JAX package's
``utils/types.py``, the reference's ``custom_types.py``): tensor aliases
over ``torch.Tensor``, debugger detection, and ``get_device``, which clamps
a card index to the cards present as the JAX helper clamps to
``jax.devices()``. It raises without CUDA (``resolve_device``): it never
returns the CPU in a card's place."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = [
    "T", "TN", "ARRAY", "ARRAYS", "VS", "VN", "TS", "D",
    "is_debugging", "get_device",
]

T = torch.Tensor
TN = Optional[torch.Tensor]
ARRAY = np.ndarray
ARRAYS = Union[Tuple[ARRAY, ...], List[ARRAY]]
VS = Union[Tuple[torch.Tensor, ...], List[torch.Tensor]]
VN = Optional[torch.Tensor]
TS = Union[Tuple[torch.Tensor, ...], List[torch.Tensor]]
D = torch.device


def is_debugging() -> bool:
    """True when running under a tracer/debugger (custom_types.py DEBUG)."""
    return sys.gettrace() is not None


def get_device(device_id: int = 0) -> torch.device:
    """``cuda:i`` with ``i`` clamped to the cards present (custom_types.py
    get_device's index clamp); raises where CUDA is not available."""
    resolve_device("cuda")
    return torch.device("cuda", min(max(device_id, 0), torch.cuda.device_count() - 1))
