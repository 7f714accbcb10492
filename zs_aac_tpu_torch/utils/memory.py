"""Training-free support-memory projection.

The counterpart of the JAX package's ``utils/memory.py``: an audio embedding
projected onto a bank of support text embeddings by ``softmax(sim * scale) @
memory``, a training-free alternative to the learned mapper for bridging the
audio/text modality gap.
"""

from __future__ import annotations

import numpy as np
import torch

from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["map_to_memory", "construct_support_memory"]


def _norm(x):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


def map_to_memory(query: torch.Tensor, memory: torch.Tensor, scale: float = 100.0):
    """query: [B, E]; memory: [N, E] -> [B, E] softmax-weighted projection."""
    w = torch.softmax(_norm(query) @ _norm(memory).t() * scale, dim=-1)
    return w @ memory


def construct_support_memory(bank_records, key: str = "text_embedding", device="cuda"):
    """The support memory [N, E] fp32 on ``device``, one row per bank record."""
    dev = resolve_device(device)
    rows = [np.asarray(r[key], np.float32).reshape(1, -1) for r in bank_records]
    return torch.from_numpy(np.concatenate(rows)).to(dev)
