"""BERT-family text encoder (the CLAP text tower), post-LN, eval only.

The counterpart of the JAX package's ``models/bert.py``: token, position and
type embeddings, LayerNorm, then post-LN encoder layers (self-attention with
an additive -1e9 mask bias, exact-erf GELU MLP). It returns the last hidden
states ``[B, L, hidden]``; the ASE model takes position 0 ([CLS]).

Parameters are the JAX tree as tensors (Dense kernels ``[in, out]``).
Attention is plain ``matmul`` + ``softmax``, as the JAX package leaves it to
XLA. ``convert_bert`` loads an HF ``BertModel`` state dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.convert import state_dict_tensors
from zs_aac_tpu_torch.models.gpt2 import _ln
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["BertConfig", "BertEncoder", "convert_bert", "init_bert"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def _dense(x, p, dt):
    return x.to(dt) @ p["kernel"].to(dt) + p["bias"].to(dt)


@dataclasses.dataclass(frozen=True)
class BertEncoder:
    """``apply(params, input_ids [B, L], attention_mask [B, L]) -> [B, L, hidden]``."""

    cfg: BertConfig
    dtype: torch.dtype = torch.float32

    def _layer(self, p, x, bias):
        c, dt = self.cfg, self.dtype
        h = c.num_attention_heads
        d = c.hidden_size // h
        B, L, _ = x.shape
        sp = p["self"]
        q, k, v = (_dense(x, sp[n], dt).reshape(B, L, h, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        att = (q @ k.transpose(-1, -2)) * float(1.0 / math.sqrt(d))
        att = torch.softmax(att + bias, dim=-1)
        a = (att @ v).transpose(1, 2).reshape(B, L, c.hidden_size)
        a = _dense(a, p["attn_out"], dt)
        x = _ln(x + a, p["attn_ln"], c.layer_norm_eps)
        f = F.gelu(_dense(x, p["intermediate"], dt))
        f = _dense(f, p["output"], dt)
        return _ln(x + f, p["out_ln"], c.layer_norm_eps)

    def apply(self, params, input_ids, attention_mask: Optional[torch.Tensor] = None,
              token_type_ids: Optional[torch.Tensor] = None):
        c, dt = self.cfg, self.dtype
        B, L = input_ids.shape
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(L, device=input_ids.device)
        x = (params["word_embeddings"]["embedding"].to(dt)[input_ids]
             + params["position_embeddings"]["embedding"].to(dt)[pos][None]
             + params["token_type_embeddings"]["embedding"].to(dt)[token_type_ids.long()])
        x = _ln(x, params["emb_ln"], c.layer_norm_eps)
        if attention_mask is None:
            bias = torch.zeros((B, 1, 1, L), dtype=dt, device=x.device)
        else:
            keep = attention_mask[:, None, None, :] > 0
            bias = torch.where(keep, 0.0, -1e9).to(dt)
        for i in range(c.num_hidden_layers):
            x = self._layer(params[f"layer{i}"], x, bias)
        return x


def init_bert(cfg: BertConfig, generator: torch.Generator, device) -> dict:
    """Seeded random parameters (flax's initializers: N(0, 1) embeddings
    scaled to 0.02, LeCun-normal kernels, zero biases, unit LN scales)."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(device)

    def dense(din, dout):
        return {"kernel": normal((din, dout), din ** -0.5), "bias": torch.zeros(dout, device=device)}

    def ln(dim):
        return {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}

    H, I = cfg.hidden_size, cfg.intermediate_size
    p = {"word_embeddings": {"embedding": normal((cfg.vocab_size, H), 0.02)},
         "position_embeddings": {"embedding": normal((cfg.max_position_embeddings, H), 0.02)},
         "token_type_embeddings": {"embedding": normal((cfg.type_vocab_size, H), 0.02)},
         "emb_ln": ln(H)}
    for i in range(cfg.num_hidden_layers):
        p[f"layer{i}"] = {"self": {n: dense(H, H) for n in ("query", "key", "value")},
                          "attn_out": dense(H, H), "attn_ln": ln(H),
                          "intermediate": dense(H, I), "output": dense(I, H),
                          "out_ln": ln(H)}
    return p


def convert_bert(state_dict: Mapping, cfg: BertConfig, device="cuda") -> dict:
    """HF ``BertModel`` state dict (keys with or without ``bert.``) ->
    ``{"params": ...}`` for ``BertEncoder``; the pooler and task heads are
    ignored, as the reference never uses them."""
    sd = state_dict_tensors({k.removeprefix("bert."): v for k, v in state_dict.items()},
                            resolve_device(device))
    get = sd.__getitem__

    def dense(src):
        return {"kernel": get(src + ".weight").t().contiguous(), "bias": get(src + ".bias")}

    def ln(src):
        return {"scale": get(src + ".weight"), "bias": get(src + ".bias")}

    p = {"word_embeddings": {"embedding": get("embeddings.word_embeddings.weight")},
         "position_embeddings": {"embedding": get("embeddings.position_embeddings.weight")},
         "token_type_embeddings": {"embedding": get("embeddings.token_type_embeddings.weight")},
         "emb_ln": ln("embeddings.LayerNorm")}
    for i in range(cfg.num_hidden_layers):
        src = f"encoder.layer.{i}"
        p[f"layer{i}"] = {
            "self": {n: dense(f"{src}.attention.self.{n}") for n in ("query", "key", "value")},
            "attn_out": dense(f"{src}.attention.output.dense"),
            "attn_ln": ln(f"{src}.attention.output.LayerNorm"),
            "intermediate": dense(f"{src}.intermediate.dense"),
            "output": dense(f"{src}.output.dense"),
            "out_ln": ln(f"{src}.output.LayerNorm"),
        }
    return {"params": p}
