"""Prefix-tuned caption model: prefix assembly, the training forward and the
cross-attention variants.

The counterpart of the JAX package's ``models/caption.py``. Parameters are
``{"mapper": nn.Module, "gpt2": dict, ["sound_effect": MLP],
["cross_attention": nn.Module]}`` and the GPT input is assembled as
[sound effects | hard prompt | soft prefix | text]. ``only_prefix`` (train the
mapper, freeze GPT-2) is an optimizer partition (``trainable_filter``), as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from zs_aac_tpu_torch.models.gpt2 import GPT2Config, gpt2_embed, gpt2_forward, init_gpt2
from zs_aac_tpu_torch.models.mapper import MLP, init_mapper_, make_mapper
from zs_aac_tpu_torch.ops.quant import div
from zs_aac_tpu_torch.parallel.mesh import all_sum
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["CaptionConfig", "sound_effect_choice", "init_caption_model", "prefix_projections",
           "caption_embeddings", "caption_train_logits", "caption_loss", "trainable_filter",
           "SoundEffectCrossAttention", "init_cross_attention", "cross_attention_prefix",
           "caption_cross_train_logits"]


@dataclasses.dataclass(frozen=True)
class CaptionConfig:
    prefix_length: int = 10
    prefix_size: int = 1024  # CLAP embedding dim
    clip_length: int = 10
    num_layers: int = 8
    mapping_type: str = "mlp"
    only_prefix: bool = False
    only_soft_prompt: bool = False
    sound_effect_num: int = 0
    max_seq_len: int = 25
    gpt2: GPT2Config = dataclasses.field(default_factory=GPT2Config)

    @property
    def gpt_embedding_size(self) -> int:
        return self.gpt2.n_embd


def sound_effect_choice(prefix: torch.Tensor, label_embeddings: torch.Tensor, k: int):
    """Indices [B, k] of the ``k`` AudioSet labels most similar to each
    prefix (``prefix`` [B, E] or [B, 1, E]; ``label_embeddings`` [N, E])."""
    if prefix.ndim == 3:
        prefix = prefix[:, 0]
    return torch.topk(prefix @ label_embeddings.t(), k, dim=-1).indices


def _sound_effect_mlp(cfg: CaptionConfig, device) -> MLP:
    return MLP((cfg.prefix_size, cfg.gpt_embedding_size // 2, cfg.gpt_embedding_size),
               device=device)


def init_caption_model(cfg: CaptionConfig, seed: int = 0, device="cuda",
                       gpt2_params: Optional[dict] = None,
                       with_sound_effect: bool = False) -> dict:
    """Seeded random caption model (mapper + GPT-2, and the sound-effect MLP
    where ``with_sound_effect`` or ``cfg.sound_effect_num``) on ``device``;
    ``gpt2_params`` replaces the random GPT-2."""
    dev = resolve_device(device)
    mapper = make_mapper(cfg.mapping_type, cfg.prefix_size, cfg.gpt_embedding_size,
                         cfg.prefix_length, cfg.clip_length, cfg.num_layers, dev)
    params = {"mapper": init_mapper_(mapper, seed),
              "gpt2": gpt2_params if gpt2_params is not None
              else init_gpt2(cfg.gpt2, seed + 1, dev)}
    if with_sound_effect or cfg.sound_effect_num:
        params["sound_effect"] = init_mapper_(_sound_effect_mlp(cfg, dev), seed + 2)
    return params


def prefix_projections(params: dict, cfg: CaptionConfig, prefix: torch.Tensor):
    """Mapper output reshaped to ``[B, prefix_length, D]``."""
    out = params["mapper"](prefix)
    return out.reshape(-1, cfg.prefix_length, cfg.gpt_embedding_size)


def caption_embeddings(params: dict, cfg: CaptionConfig, prefix: torch.Tensor,
                       hard_prompt_tokens: Optional[torch.Tensor] = None,
                       text_tokens: Optional[torch.Tensor] = None,
                       label_embeddings: Optional[torch.Tensor] = None, tp=None):
    """Assemble GPT input embeddings [sound | hard | soft_prefix | text] from
    ``prefix`` [B, prefix_size], optional token ids [B, S] and, for the
    sound-effect tokens, the label bank ``label_embeddings`` [N, E]. ``tp``:
    the ``model`` axis, GPT-2 this rank's shard (``parallel.tp``). Span
    ``decode.mapper``."""
    with annotate("decode.mapper"):
        parts = []
        if cfg.sound_effect_num and label_embeddings is not None:
            idx = sound_effect_choice(prefix, label_embeddings, cfg.sound_effect_num)
            parts.append(params["sound_effect"](label_embeddings[idx]))
        if hard_prompt_tokens is not None and not cfg.only_soft_prompt:
            parts.append(gpt2_embed(params["gpt2"], hard_prompt_tokens, tp))
        parts.append(prefix_projections(params, cfg, prefix))
        if text_tokens is not None:
            parts.append(gpt2_embed(params["gpt2"], text_tokens, tp))
        return torch.cat(parts, dim=1)


def caption_train_logits(params: dict, cfg: CaptionConfig, tokens: torch.Tensor,
                         prefix: torch.Tensor, mask: torch.Tensor,
                         hard_prompt_tokens: Optional[torch.Tensor] = None,
                         hard_prompt_mask: Optional[torch.Tensor] = None,
                         label_embeddings: Optional[torch.Tensor] = None, tp=None):
    """Training forward: logits aligned to predict ``tokens`` [B, S]. The
    full mask is [sound ones | hard_prompt_mask | mask] (``mask``: the
    dataset's [B, prefix_length + S]); the slice is ``logits[:, h +
    prefix_length - 1 : -1]``, h the sound and hard tokens."""
    embeds = caption_embeddings(params, cfg, prefix, hard_prompt_tokens, tokens,
                                label_embeddings, tp)
    full_mask = mask
    h = 0
    if hard_prompt_tokens is not None and not cfg.only_soft_prompt:
        h = hard_prompt_tokens.shape[1]
        full_mask = torch.cat([hard_prompt_mask, mask], dim=1)
    if cfg.sound_effect_num and label_embeddings is not None:
        ones = torch.ones(prefix.shape[0], cfg.sound_effect_num, dtype=full_mask.dtype,
                          device=full_mask.device)
        full_mask = torch.cat([ones, full_mask], dim=1)
        h += cfg.sound_effect_num
    logits = gpt2_forward(params["gpt2"], cfg.gpt2, embeds, full_mask, tp)
    return logits[:, h + cfg.prefix_length - 1:-1]


def caption_loss(logits: torch.Tensor, tokens: torch.Tensor, data=None) -> torch.Tensor:
    """Next-token cross-entropy, token id 0 ignored (the reference's
    ``ignore_index=0``): the mean over the other positions. Under ``data``
    (``parallel.mesh.Axis``; this rank's rows) this rank's share of the
    global batch's mean: its rows' sum over the global count, so that the
    shares sum to the loss."""
    valid = (tokens != 0).to(logits.dtype)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1),
                         reduction="none").reshape(tokens.shape)
    return (ce * valid).sum() / torch.clamp_min(all_sum(valid.sum(), data), 1)


def trainable_filter(cfg: CaptionConfig):
    """Label function of the optimizer partition: each top-level entry of
    the parameter tree is "trainable", GPT-2 "frozen" when ``only_prefix``."""

    def label(params):
        return {k: "frozen" if cfg.only_prefix and k == "gpt2" else "trainable"
                for k in params}

    return label


# ---------------------------------------------------------------------------
# Cross-attention variants (the reference's ClapCaptionCrossattention / _v2)
# ---------------------------------------------------------------------------


class SoundEffectCrossAttention(nn.Module):
    """``nn.MultiheadAttention(dim, num_heads)`` as the JAX package writes it:
    separate q/k/v projections with biases, then an output projection."""

    def __init__(self, dim: int, num_heads: int = 4, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(dim, dim, device=device) for _ in range(4))

    def forward(self, q, kv, key_mask=None):  # q: [B, 1, E], kv: [B, k, E]
        B, _, E = q.shape
        h = self.num_heads
        d = E // h
        qp = self.q_proj(q).reshape(B, 1, h, d).transpose(1, 2)
        kp = self.k_proj(kv).reshape(B, -1, h, d).transpose(1, 2)
        vp = self.v_proj(kv).reshape(B, -1, h, d).transpose(1, 2)
        att = div(qp @ kp.transpose(-1, -2), math.sqrt(d))
        if key_mask is not None:  # [B, 1, k], True = masked out
            att = att.masked_fill(key_mask[:, None], -1e9)
        out = torch.softmax(att, dim=-1) @ vp
        return self.out_proj(out.transpose(1, 2).reshape(B, 1, E))


@torch.no_grad()
def init_cross_attention(cfg: CaptionConfig, seed: int = 0, device="cuda"):
    """Seeded cross-attention module (matrices N(0, 1/sqrt(dim)), zero
    biases) on ``device``."""
    dev = resolve_device(device)
    mod = SoundEffectCrossAttention(cfg.prefix_size, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for name, p in mod.named_parameters():
        if p.ndim == 2:
            p.copy_(torch.randn(p.shape, generator=g, device=dev) / math.sqrt(p.shape[1]))
        else:
            p.zero_()
    return mod


def cross_attention_prefix(params: dict, cfg: CaptionConfig, prefix: torch.Tensor,
                           label_embeddings: torch.Tensor, version: int = 1,
                           train: bool = False, mask_probability: float = 0.25,
                           generator=None):
    """The CLAP prefix refined by cross-attending over its top-k sound
    effects. v1 replaces the prefix; v2 adds it back as a residual and, in
    training, masks each effect with ``mask_probability``, re-opening one
    random effect where a row masked them all."""
    idx = sound_effect_choice(prefix, label_embeddings, cfg.sound_effect_num)
    chosen = label_embeddings[idx]  # [B, k, E]
    key_mask = None
    if version == 2 and train:
        if generator is None:
            raise ValueError("v2 training masking needs a generator")
        B, k, dev = prefix.shape[0], cfg.sound_effect_num, prefix.device
        m = torch.rand(B, 1, k, generator=generator, device=dev) < mask_probability
        all_masked = m.sum(dim=-1, keepdim=True) == k
        reopen = F.one_hot(torch.randint(0, k, (B, 1), generator=generator, device=dev),
                           k).bool()
        key_mask = torch.where(all_masked, m & ~reopen, m)
    out = params["cross_attention"](prefix[:, None], chosen, key_mask)[:, 0]
    return out if version == 1 else out + prefix


def caption_cross_train_logits(params: dict, cfg: CaptionConfig, tokens: torch.Tensor,
                               prefix: torch.Tensor, mask: torch.Tensor,
                               label_embeddings: torch.Tensor, version: int = 1,
                               train: bool = True, mask_probability: float = 0.25,
                               generator=None):
    """Cross-attention caption forward; logits aligned as the base model's
    without hard prompts (slice ``prefix_length - 1 : -1``)."""
    refined = cross_attention_prefix(params, cfg, prefix, label_embeddings, version, train,
                                     mask_probability, generator)
    embeds = torch.cat([prefix_projections(params, cfg, refined),
                        gpt2_embed(params["gpt2"], tokens)], dim=1)
    logits = gpt2_forward(params["gpt2"], cfg.gpt2, embeds, mask)
    return logits[:, cfg.prefix_length - 1:-1]
