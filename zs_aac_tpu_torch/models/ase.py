"""ASE, the CLAP audio-text embedding model.

The counterpart of the JAX package's ``models/ase.py``: an audio tower
(Cnn14, ResNet38 or HTSAT) and a BERT-family text tower, each projected by a
Linear-ReLU-Linear head into the shared ``embed_size`` space and
L2-normalized. Variables are the JAX tree as tensors: ``{"params":
{"audio_enc", "text_enc", "audio_proj", "text_proj", "temp"}, "batch_stats":
{"audio_enc": ...}}``.

The audio towers are ``models/cnns.py``'s and ``models/htsat.py``'s; the
text tower is picked by ``text_model`` as the JAX ``ASE.setup`` picks it: a
name of ``CLIP_TEXT_REGISTRY`` builds ``models/text_towers.py``'s
``CLIPTextEncoder``, one of ``GPT2_TEXT_REGISTRY`` its ``GPT2TextEncoder``,
any other the BERT-family ``BertEncoder`` of ``TEXT_MODEL_REGISTRY``.
``ASE.__call__`` is the JAX ``ASE.__call__`` (the bidirectional soft-target
``atc_loss`` with multi-positive targets from the audio ids, the learnable
temperature, the embedding regularization), and ``ntxent_loss`` is ported
beside it.

The ASE embeds a caption by the text tower's position 0. The GPT-2 and CLIP
towers are causal, and WordPiece puts ``[CLS]`` first in every row, so under
those towers every caption gets the same embedding, in the JAX package as
here: a property of the reference that the port keeps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from zs_aac_tpu_torch.models.bert import BertConfig, BertEncoder, init_bert
from zs_aac_tpu_torch.models.cnns import Cnn14, ResNet38
from zs_aac_tpu_torch.models.htsat import HTSAT
from zs_aac_tpu_torch.models.text_towers import (CLIPTextConfig, CLIPTextEncoder,
                                                 GPT2EncoderConfig, GPT2TextEncoder,
                                                 init_clip_text, init_gpt2_encoder)
from zs_aac_tpu_torch.parallel.mesh import gather_rows
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["ASEConfig", "ASE", "TEXT_MODEL_REGISTRY", "CLIP_TEXT_REGISTRY", "GPT2_TEXT_REGISTRY",
           "text_config", "init_ase", "atc_loss", "ntxent_loss"]


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

# The CLIP and GPT-2 towers (the JAX package's registries, its tiny test
# geometries included): name -> CLIPTextConfig / GPT2EncoderConfig kwargs.
CLIP_TEXT_REGISTRY = {
    "openai/clip-vit-base-patch32": dict(),
    "clip-tiny": dict(vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
                      intermediate_size=64, max_positions=32),  # tests
}

GPT2_TEXT_REGISTRY = {
    "gpt2": dict(n_layer=12, n_embd=768, n_head=12),
    "distilgpt2": dict(n_layer=6, n_embd=768, n_head=12),
    "gpt2-tiny": dict(vocab_size=256, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4),  # tests
}


def text_config(name: str) -> BertConfig:
    """A BERT-family tower's config (a CLIP or GPT-2 name is a ``KeyError``,
    as in the JAX package)."""
    return BertConfig(**TEXT_MODEL_REGISTRY[name])


def build_text_tower(name: str, dtype=torch.float32):
    """The text tower ``ASE`` builds for ``name``."""
    if name in CLIP_TEXT_REGISTRY:
        return CLIPTextEncoder(CLIPTextConfig(**CLIP_TEXT_REGISTRY[name]), dtype)
    if name in GPT2_TEXT_REGISTRY:
        return GPT2TextEncoder(GPT2EncoderConfig(**GPT2_TEXT_REGISTRY[name]), dtype)
    return BertEncoder(text_config(name), dtype)


def text_width(tower) -> int:
    """The width of a text tower's hidden states."""
    c = tower.cfg
    return c.n_embd if isinstance(c, GPT2EncoderConfig) else c.hidden_size


@dataclasses.dataclass(frozen=True)
class ASEConfig:
    embed_size: int = 1024
    temp: float = 0.07
    embed_regularization: bool = True
    audio_encoder: str = "cnn14"      # "cnn14" | "resnet38" | "htsat"
    text_model: str = "bert-base-uncased"
    spec_augmentation: bool = True
    audio_channels: Optional[tuple] = None   # Cnn14's block widths
    # mel bins of the spectrogram, the width of the Cnn towers' bn0 (which
    # the JAX init reads off its example input); HTSAT's is in htsat_kwargs
    n_mels: int = 64
    # HTSAT geometry overrides as (key, value) pairs (hashable)
    htsat_kwargs: Optional[tuple] = None
    fused_attn: Any = False
    fused_block: Any = False
    dtype: Any = torch.float32


def atc_loss(sim_a2t, sim_t2a, sim_targets=None):
    """Bidirectional soft-target contrastive loss (the JAX ``atc_loss``)."""
    if sim_targets is None:
        sim_targets = torch.eye(sim_a2t.shape[0], dtype=sim_a2t.dtype, device=sim_a2t.device)
    loss_a2t = -(torch.log_softmax(sim_a2t, dim=1) * sim_targets).sum(dim=1).mean()
    loss_t2a = -(torch.log_softmax(sim_t2a, dim=1) * sim_targets).sum(dim=1).mean()
    return (loss_a2t + loss_t2a) / 2


def ntxent_loss(audio_embeds, text_embeds, temperature: float = 0.07):
    """Cosine-similarity NT-Xent (the JAX ``ntxent_loss``)."""
    a, t = _l2norm(audio_embeds), _l2norm(text_embeds)
    a2t = a @ t.T / temperature
    t2a = t @ a.T / temperature
    return 0.5 * (-torch.log_softmax(a2t, dim=1).mean() - torch.log_softmax(t2a, dim=1).mean())


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
        common = dict(spec_augmentation=cfg.spec_augmentation, dtype=cfg.dtype)
        if cfg.audio_encoder == "cnn14":
            kw = {"channels": tuple(cfg.audio_channels)} if cfg.audio_channels else {}
            self.audio_enc = Cnn14(n_mels=cfg.n_mels, **common, **kw)
        elif cfg.audio_encoder == "resnet38":
            self.audio_enc = ResNet38(n_mels=cfg.n_mels, **common)
        elif cfg.audio_encoder == "htsat":
            kw = dict(common, fused_attn=cfg.fused_attn, fused_block=cfg.fused_block)
            kw.update(dict(cfg.htsat_kwargs) if cfg.htsat_kwargs else {})
            self.audio_enc = HTSAT(**kw)
        else:
            raise ValueError(f"unknown audio encoder {cfg.audio_encoder!r}")
        self.text_enc = build_text_tower(cfg.text_model, cfg.dtype)

    def _audio(self, variables, spec, train: bool, generator, data=None):
        """(L2-normalized audio embeddings, the tower's new batch_stats or None)."""
        p = variables["params"]
        out = self.audio_enc.apply({"params": p["audio_enc"],
                                    "batch_stats": variables["batch_stats"]["audio_enc"]},
                                   spec, train=train, generator=generator, data=data)
        feats, stats = out if train else (out, None)
        return _l2norm(_proj(feats, p["audio_proj"], self.cfg.dtype)), stats

    def encode_audio(self, variables, spec, train: bool = False, generator=None):
        """spec: [B, T, F] log-mel -> [B, embed_size] L2-normalized."""
        return self._audio(variables, spec, train, generator)[0]

    def encode_text(self, variables, input_ids, attention_mask=None, train: bool = False):
        """-> [B, embed_size] L2-normalized projection of position 0 (the
        text towers have no dropout, so ``train`` changes nothing)."""
        p = variables["params"]
        hidden = self.text_enc.apply(p["text_enc"], input_ids, attention_mask)
        return _l2norm(_proj(hidden[:, 0, :], p["text_proj"], self.cfg.dtype))

    def __call__(self, variables, spec, input_ids, attention_mask, idx, train: bool = True,
                 generator: Optional[torch.Generator] = None, data=None):
        """Contrastive loss over a batch -> ``(loss, new_batch_stats)``;
        ``idx`` marks same-audio positives; ``generator`` feeds the audio
        tower's spec augmentation and drop path in train mode. Under
        ``data`` (a ``parallel.mesh.Axis``) the inputs are this rank's rows
        and the loss is the global batch's on every rank: the tower's batch
        statistics and draws are global, and the embeddings and ``idx`` are
        gathered (``gather_rows``) before the similarity matrices."""
        audio, stats = self._audio(variables, spec, train, generator, data)
        text = self.encode_text(variables, input_ids, attention_mask, train=train)
        idx = torch.as_tensor(idx, device=audio.device)
        audio, text, idx = (gather_rows(t, data) for t in (audio, text, idx))
        pos = (idx[:, None] == idx[None, :]).to(audio.dtype)
        targets = pos / pos.sum(dim=1, keepdim=True)
        temp = variables["params"]["temp"]
        sim_a2t = (audio @ text.T).float() / temp
        sim_t2a = (text @ audio.T).float() / temp
        loss = atc_loss(sim_a2t, sim_t2a, targets.float())
        if self.cfg.embed_regularization:
            a, t = audio.float(), text.float()
            loss = (loss + a.abs().mean() / torch.sqrt(a.square().sum())
                    + t.abs().mean() / torch.sqrt(t.square().sum()))
        new = {"audio_enc": stats} if stats is not None else variables["batch_stats"]
        return loss, new


def init_ase(cfg: ASEConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random variables for ``ASE(cfg)`` on ``device``."""
    dev = resolve_device(device)
    ase = ASE(cfg)
    audio = ase.audio_enc.init(seed, dev)
    # HTSAT's head, never called by the ASE (nor in the JAX init tree)
    audio["params"].pop("tscam_conv", None)
    g = torch.Generator().manual_seed(seed + 1)

    def proj(din):
        E = cfg.embed_size
        return {"fc1": {"kernel": (torch.randn(din, E, generator=g) * din ** -0.5).to(dev),
                        "bias": torch.zeros(E, device=dev)},
                "fc2": {"kernel": (torch.randn(E, E, generator=g) * E ** -0.5).to(dev),
                        "bias": torch.zeros(E, device=dev)}}

    tower = ase.text_enc
    if isinstance(tower, CLIPTextEncoder):
        text = init_clip_text(tower.cfg, g, dev)
    elif isinstance(tower, GPT2TextEncoder):
        text = init_gpt2_encoder(tower.cfg, g, dev)
    else:
        text = init_bert(tower.cfg, g, dev)
    params = {"audio_enc": audio["params"], "text_enc": text,
              "audio_proj": proj(ase.audio_enc.num_features),
              "text_proj": proj(text_width(tower)),
              "temp": torch.tensor(cfg.temp, device=dev)}
    return {"params": params, "batch_stats": {"audio_enc": audio["batch_stats"]}}
