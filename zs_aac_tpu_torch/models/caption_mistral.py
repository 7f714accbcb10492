"""Mistral-based prefix caption model (the multilingual captioner).

The counterpart of the JAX package's ``models/caption_mistral.py``: the
mapper projects the CLAP embedding to ``prefix_length`` Mistral token
embeddings (cast to the base's dtype), hard prompts go before them, and the
captions carry ``islang`` language-tag tokens whose positions are left out
of the cross-entropy. Parameters are ``{"mapper": nn.Module, "lora": dict,
"mistral": dict}``; the base is frozen, the mapper and LoRA train.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.mapper import init_mapper_, make_mapper
from zs_aac_tpu_torch.models.mistral import (MistralConfig, init_lora, init_mistral,
                                             mistral_embed, mistral_forward)
from zs_aac_tpu_torch.parallel.mesh import all_sum
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = [
    "MistralCaptionConfig",
    "init_mistral_caption",
    "mistral_caption_embeddings",
    "mistral_caption_train_logits",
    "mistral_caption_loss",
]


@dataclasses.dataclass(frozen=True)
class MistralCaptionConfig:
    prefix_length: int = 10
    prefix_size: int = 1024
    clip_length: int = 10
    num_layers: int = 8
    mapping_type: str = "mlp"
    only_soft_prompt: bool = False
    islang: int = 0              # language-tag token count
    max_seq_len: int = 40
    lora_r: int = 8
    lora_alpha: int = 16
    mistral: MistralConfig = dataclasses.field(default_factory=MistralConfig)


def init_mistral_caption(cfg: MistralCaptionConfig, seed: int = 0, device="cuda",
                         mistral_params: Optional[dict] = None) -> dict:
    """Seeded mapper (fp32) and LoRA (fp32, ``b`` = 0), and the base from
    ``mistral_params`` or ``init_mistral`` (bf16)."""
    dev = resolve_device(device)
    mapper = make_mapper(cfg.mapping_type, cfg.prefix_size, cfg.mistral.hidden_size,
                         cfg.prefix_length, cfg.clip_length, cfg.num_layers, dev)
    return {
        "mapper": init_mapper_(mapper, seed),
        "lora": init_lora(cfg.mistral, cfg.lora_r, cfg.lora_alpha, seed + 1, dev),
        "mistral": mistral_params if mistral_params is not None
        else init_mistral(cfg.mistral, seed + 2, dev),
    }


def mistral_caption_embeddings(params, cfg: MistralCaptionConfig, prefix,
                               hard_prompt_tokens=None, text_tokens=None, tp=None):
    """[hard prompt | mapper prefix | text] embeddings in the base's dtype
    (``tp``: the ``model`` axis, with the base and LoRA this rank's shards).
    Span ``decode.mapper``."""
    with annotate("decode.mapper"):
        proj = params["mapper"](prefix).reshape(-1, cfg.prefix_length, cfg.mistral.hidden_size)
        proj = proj.to(params["mistral"]["embed"].dtype)
        parts = []
        if hard_prompt_tokens is not None and not cfg.only_soft_prompt:
            parts.append(mistral_embed(params["mistral"], hard_prompt_tokens, tp))
        parts.append(proj)
        if text_tokens is not None:
            parts.append(mistral_embed(params["mistral"], text_tokens, tp))
        return torch.cat(parts, dim=1)


def mistral_caption_train_logits(params, cfg: MistralCaptionConfig, tokens, prefix, mask,
                                 hard_prompt_tokens=None, hard_prompt_mask=None, tp=None):
    """Logits aligned to predict ``tokens[:, islang:]``."""
    embeds = mistral_caption_embeddings(params, cfg, prefix, hard_prompt_tokens, tokens, tp)
    full_mask = mask
    h = 0
    if hard_prompt_tokens is not None and not cfg.only_soft_prompt:
        h = hard_prompt_tokens.shape[1]
        full_mask = torch.cat([hard_prompt_mask, mask], dim=1)
    logits = mistral_forward(params["mistral"], cfg.mistral, embeds, full_mask,
                             lora=params["lora"], tp=tp)
    start = h + cfg.prefix_length + cfg.islang - 1
    return logits[:, start:-1]


def mistral_caption_loss(logits, tokens, islang: int, data=None) -> torch.Tensor:
    """Cross-entropy against ``tokens[:, islang:]`` in fp32, token 0
    ignored: the mean over the other positions (under ``data`` this rank's
    share of the global mean, as ``models.caption.caption_loss``)."""
    targets = tokens[:, islang:]
    valid = (targets != 0).float()
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), targets.reshape(-1),
                         reduction="none").reshape(targets.shape)
    return (ce * valid).sum() / torch.clamp_min(all_sum(valid.sum(), data), 1)
