"""ASE, the CLAP audio-text embedding model, eval only.

The counterpart of the JAX package's ``models/ase.py``: the HTSAT audio
tower and a BERT-family text tower, each projected by a Linear-ReLU-Linear
head into the shared ``embed_size`` space and L2-normalized. Variables are
the JAX tree as tensors: ``{"params": {"audio_enc", "text_enc",
"audio_proj", "text_proj", "temp"}, "batch_stats": {"audio_enc": ...}}``.

Ported: the HTSAT audio tower and the BERT text towers of the registry.
The Cnn14 and ResNet38 audio towers, the CLIP and GPT-2 text towers and the
contrastive loss wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from zs_aac_tpu_torch.models.bert import BertConfig, BertEncoder, init_bert
from zs_aac_tpu_torch.models.htsat import HTSAT
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["ASEConfig", "ASE", "TEXT_MODEL_REGISTRY", "text_config", "init_ase"]


# name -> BertConfig kwargs (the JAX package's registry, itself the reference
# text_encoder.py's table), plus one tiny test geometry.
TEXT_MODEL_REGISTRY = {
    "prajjwal1/bert-tiny": dict(hidden_size=128, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=512),
    "prajjwal1/bert-mini": dict(hidden_size=256, num_hidden_layers=4,
                                num_attention_heads=4, intermediate_size=1024),
    "prajjwal1/bert-small": dict(hidden_size=512, num_hidden_layers=4,
                                 num_attention_heads=8, intermediate_size=2048),
    "prajjwal1/bert-medium": dict(hidden_size=512, num_hidden_layers=8,
                                  num_attention_heads=8, intermediate_size=2048),
    "bert-base-uncased": dict(hidden_size=768, num_hidden_layers=12,
                              num_attention_heads=12, intermediate_size=3072),
    "bert-large-uncased": dict(hidden_size=1024, num_hidden_layers=24,
                               num_attention_heads=16, intermediate_size=4096),
    "roberta-base": dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12,
                         num_attention_heads=12, intermediate_size=3072,
                         max_position_embeddings=514),
    "roberta-large": dict(vocab_size=50265, hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096,
                          max_position_embeddings=514),
    "distilroberta-base": dict(vocab_size=50265, hidden_size=768,
                               num_hidden_layers=6, num_attention_heads=12,
                               intermediate_size=3072,
                               max_position_embeddings=514),
    "distilbert-base-uncased": dict(hidden_size=768, num_hidden_layers=6,
                                    num_attention_heads=12,
                                    intermediate_size=3072),
    "bert-tiny-test": dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=64,
                           max_position_embeddings=32),  # tests
}

# Text towers of the JAX package that are not ported yet.
_LATER_TEXT_TOWERS = {"openai/clip-vit-base-patch32", "clip-tiny", "gpt2", "distilgpt2",
                      "gpt2-tiny"}


def text_config(name: str) -> BertConfig:
    if name in _LATER_TEXT_TOWERS:
        raise NotImplementedError(f"text tower {name!r} (CLIP/GPT-2) waits for a later slice")
    return BertConfig(**TEXT_MODEL_REGISTRY[name])


@dataclasses.dataclass(frozen=True)
class ASEConfig:
    embed_size: int = 1024
    temp: float = 0.07
    embed_regularization: bool = True
    audio_encoder: str = "cnn14"      # "cnn14" | "resnet38" | "htsat"
    text_model: str = "bert-base-uncased"
    spec_augmentation: bool = True
    audio_channels: Optional[tuple] = None
    # HTSAT geometry overrides as (key, value) pairs (hashable)
    htsat_kwargs: Optional[tuple] = None
    fused_attn: Any = False
    fused_block: Any = False
    dtype: Any = torch.float32


def _l2norm(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def _proj(x, p, dt):
    h = torch.relu(x.to(dt) @ p["fc1"]["kernel"].to(dt) + p["fc1"]["bias"].to(dt))
    return h @ p["fc2"]["kernel"].to(dt) + p["fc2"]["bias"].to(dt)


class ASE:
    """``encode_audio(variables, spec)`` and ``encode_text(variables, ids,
    mask)``, each ``-> [B, embed_size]`` L2-normalized."""

    def __init__(self, cfg: ASEConfig):
        self.cfg = cfg
        if cfg.audio_encoder != "htsat":
            raise NotImplementedError(
                f"audio tower {cfg.audio_encoder!r} (Cnn14/ResNet38) waits for a later slice")
        kw = dict(spec_augmentation=cfg.spec_augmentation, dtype=cfg.dtype,
                  fused_attn=cfg.fused_attn, fused_block=cfg.fused_block)
        kw.update(dict(cfg.htsat_kwargs) if cfg.htsat_kwargs else {})
        self.audio_enc = HTSAT(**kw)
        self.text_enc = BertEncoder(text_config(cfg.text_model), cfg.dtype)

    def encode_audio(self, variables, spec, train: bool = False):
        """spec: [B, T, F] log-mel -> [B, embed_size] L2-normalized."""
        p = variables["params"]
        feats = self.audio_enc.apply({"params": p["audio_enc"],
                                      "batch_stats": variables["batch_stats"]["audio_enc"]},
                                     spec, train=train)
        return _l2norm(_proj(feats, p["audio_proj"], self.cfg.dtype))

    def encode_text(self, variables, input_ids, attention_mask=None, train: bool = False):
        """-> [B, embed_size] L2-normalized [CLS] projection."""
        if train:
            raise NotImplementedError("ASE training waits for a later slice")
        p = variables["params"]
        hidden = self.text_enc.apply(p["text_enc"], input_ids, attention_mask)
        return _l2norm(_proj(hidden[:, 0, :], p["text_proj"], self.cfg.dtype))


def init_ase(cfg: ASEConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random variables for ``ASE(cfg)`` on ``device``."""
    dev = resolve_device(device)
    ase = ASE(cfg)
    audio = ase.audio_enc.init(seed, dev)
    audio["params"].pop("tscam_conv")  # never called by the ASE (nor in the JAX init tree)
    g = torch.Generator().manual_seed(seed + 1)

    def proj(din):
        E = cfg.embed_size
        return {"fc1": {"kernel": (torch.randn(din, E, generator=g) * din ** -0.5).to(dev),
                        "bias": torch.zeros(E, device=dev)},
                "fc2": {"kernel": (torch.randn(E, E, generator=g) * E ** -0.5).to(dev),
                        "bias": torch.zeros(E, device=dev)}}

    params = {"audio_enc": audio["params"],
              "text_enc": init_bert(ase.text_enc.cfg, g, dev),
              "audio_proj": proj(ase.audio_enc.num_features),
              "text_proj": proj(ase.text_enc.cfg.hidden_size),
              "temp": torch.tensor(cfg.temp, device=dev)}
    return {"params": params, "batch_stats": {"audio_enc": audio["batch_stats"]}}
