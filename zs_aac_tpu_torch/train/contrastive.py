"""The ASE encoders as the bank build and retrieval call them.

The counterpart of ``make_encode_fns`` in the JAX package's
``train/contrastive.py``: audio goes through the log-mel frontend (kernel K2
on the card, ``ops.logmel.log_mel``) and ``ASE.encode_audio``; text through
``ASE.encode_text``. The contrastive train step waits for the training
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from zs_aac_tpu_torch.models.ase import ASE
from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["make_encode_fns"]


def make_encode_fns(ase: ASE, mel_cfg: Optional[LogMelConfig] = None, device="cuda"):
    """Eval-mode ``(encode_audio(variables, wave [B, T]), encode_text(
    variables, input_ids, attention_mask))``, each returning [B, embed_size];
    inputs are moved to ``device``."""
    dev = resolve_device(device)
    mel_cfg = mel_cfg or LogMelConfig()

    @torch.no_grad()
    def encode_audio(variables, wave):
        spec = log_mel(torch.as_tensor(wave).to(dev), mel_cfg)[:, 0]
        return ase.encode_audio(variables, spec)

    @torch.no_grad()
    def encode_text(variables, input_ids, attention_mask):
        return ase.encode_text(variables, torch.as_tensor(input_ids).to(dev),
                               torch.as_tensor(attention_mask).to(dev))

    return encode_audio, encode_text
