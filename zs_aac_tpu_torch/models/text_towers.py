"""Text towers beyond BERT: the GPT-2 and CLIP sentence encoders.

The counterpart of the JAX package's ``models/text_towers.py`` (the
reference's ``text_encoder.py`` registry rows ``gpt2``, ``distilgpt2`` and
``openai/clip-vit-base-patch32``): token ids in, last hidden states
``[B, L, D]`` out, for the ASE head to take position 0.

- ``GPT2TextEncoder``: HF ``GPT2Model`` numerics, pre-LN blocks, fused
  ``c_attn``, ``gelu_new`` (``F.gelu(approximate="tanh")``, held to the
  JAX formula by the tests), a causal bias plus a padding bias of -1e9 each,
  summed and cast to the tower's dtype, and ``ln_f``.
- ``CLIPTextEncoder``: HF ``CLIPTextModel`` numerics, separate
  ``q/k/v_proj``, ``quick_gelu`` and ``final_layer_norm``, the same mask.

Both are pure functions over the JAX-shaped parameter dict
(``apply(params, input_ids, attention_mask)``, Dense kernels ``[in, out]``),
as ``models/bert.py`` is: Dense layers in the compute dtype, LayerNorm
statistics in fp32, attention as plain ``matmul`` + ``softmax`` over cuBLAS
(the JAX towers are XLA math; no kernel of the TPU's is on this path).
``convert_gpt2_encoder`` and ``convert_clip_text`` read HF-layout state
dicts; ``init_gpt2_encoder`` and ``init_clip_text`` draw flax's default
initializers from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.bert import _dense
from zs_aac_tpu_torch.models.convert import state_dict_tensors
from zs_aac_tpu_torch.models.gpt2 import _ln
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["GPT2EncoderConfig", "GPT2TextEncoder", "convert_gpt2_encoder", "init_gpt2_encoder",
           "CLIPTextConfig", "CLIPTextEncoder", "convert_clip_text", "init_clip_text"]


@dataclasses.dataclass(frozen=True)
class GPT2EncoderConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    n_layer: int = 12
    n_head: int = 8
    intermediate_size: int = 2048
    max_positions: int = 77
    layer_norm_eps: float = 1e-5


def _mask_bias(input_ids, attention_mask, dt):
    """[B or 1, 1, L, L]: -1e9 above the diagonal plus -1e9 at padded keys,
    summed in fp32 and cast to ``dt`` (the JAX towers' bias)."""
    L = input_ids.shape[1]
    dev = input_ids.device
    causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
    bias = torch.where(causal, 0.0, -1e9)[None, None]
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
    return bias.to(dt)


def _attention(q, k, v, bias, n_head):
    B, L, D = q.shape
    d = D // n_head
    q, k, v = (t.reshape(B, L, n_head, d).transpose(1, 2) for t in (q, k, v))
    att = (q @ k.transpose(-1, -2)) * float(1.0 / math.sqrt(d))
    att = torch.softmax(att + bias, dim=-1)
    return (att @ v).transpose(1, 2).reshape(B, L, D)


@dataclasses.dataclass(frozen=True)
class GPT2TextEncoder:
    """``apply(params, input_ids [B, L], attention_mask [B, L]) -> [B, L, n_embd]``."""

    cfg: GPT2EncoderConfig
    dtype: torch.dtype = torch.float32

    def _block(self, p, x, bias):
        c, dt = self.cfg, self.dtype
        h = _ln(x, p["ln_1"], c.layer_norm_epsilon)
        q, k, v = _dense(h, p["c_attn"], dt).split(c.n_embd, dim=-1)
        x = x + _dense(_attention(q, k, v, bias, c.n_head), p["c_proj"], dt)
        h = _ln(x, p["ln_2"], c.layer_norm_epsilon)
        h = F.gelu(_dense(h, p["c_fc"], dt), approximate="tanh")
        return x + _dense(h, p["mlp_proj"], dt)

    def apply(self, params, input_ids, attention_mask: Optional[torch.Tensor] = None,
              token_type_ids=None):
        c, dt = self.cfg, self.dtype
        ids = input_ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (params["wte"]["embedding"].to(dt)[ids]
             + params["wpe"]["embedding"].to(dt)[pos][None])
        bias = _mask_bias(ids, attention_mask, dt)
        for i in range(c.n_layer):
            x = self._block(params[f"h{i}"], x, bias)
        return _ln(x, params["ln_f"], c.layer_norm_epsilon)


@dataclasses.dataclass(frozen=True)
class CLIPTextEncoder:
    """``apply(params, input_ids [B, L], attention_mask [B, L]) -> [B, L, hidden]``."""

    cfg: CLIPTextConfig
    dtype: torch.dtype = torch.float32

    def _block(self, p, x, bias):
        c, dt = self.cfg, self.dtype
        h = _ln(x, p["layer_norm1"], c.layer_norm_eps)
        q, k, v = (_dense(h, p[n], dt) for n in ("q_proj", "k_proj", "v_proj"))
        x = x + _dense(_attention(q, k, v, bias, c.n_head), p["out_proj"], dt)
        h = _ln(x, p["layer_norm2"], c.layer_norm_eps)
        h = _dense(h, p["fc1"], dt)
        h = h * torch.sigmoid(1.702 * h)                   # quick_gelu
        return x + _dense(h, p["fc2"], dt)

    def apply(self, params, input_ids, attention_mask: Optional[torch.Tensor] = None,
              token_type_ids=None):
        c, dt = self.cfg, self.dtype
        ids = input_ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = (params["token_embedding"]["embedding"].to(dt)[ids]
             + params["position_embedding"]["embedding"].to(dt)[pos][None])
        bias = _mask_bias(ids, attention_mask, dt)
        for i in range(c.n_layer):
            x = self._block(params[f"layer{i}"], x, bias)
        return _ln(x, params["final_layer_norm"], c.layer_norm_eps)


# -- seeded initialization (flax's default initializers) -------------------------


class _Init:
    """flax's defaults drawn from ``generator`` on the CPU, then moved: Dense
    kernels LeCun normal (a normal truncated at two standard deviations,
    rescaled to variance 1/fan_in), zero biases; embeddings
    ``default_embed_init`` (normal, variance 1/features); LayerNorm ones and
    zeros."""

    def __init__(self, generator: torch.Generator, device):
        self.g, self.dev = generator, device

    def dense(self, din, dout):
        w = torch.empty(din, dout)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=self.g)
        w = w * (din ** -0.5 / 0.87962566103423978)
        return {"kernel": w.to(self.dev), "bias": torch.zeros(dout, device=self.dev)}

    def embed(self, n, dim):
        return {"embedding": (torch.randn(n, dim, generator=self.g) * dim ** -0.5).to(self.dev)}

    def ln(self, dim):
        return {"scale": torch.ones(dim, device=self.dev),
                "bias": torch.zeros(dim, device=self.dev)}


def init_gpt2_encoder(cfg: GPT2EncoderConfig, generator: torch.Generator, device="cuda") -> dict:
    """Seeded random parameters of ``GPT2TextEncoder(cfg)`` on ``device``."""
    init = _Init(generator, resolve_device(device))
    D = cfg.n_embd
    p = {"wte": init.embed(cfg.vocab_size, D), "wpe": init.embed(cfg.n_positions, D)}
    for i in range(cfg.n_layer):
        p[f"h{i}"] = {"ln_1": init.ln(D), "c_attn": init.dense(D, 3 * D),
                      "c_proj": init.dense(D, D), "ln_2": init.ln(D),
                      "c_fc": init.dense(D, 4 * D), "mlp_proj": init.dense(4 * D, D)}
    p["ln_f"] = init.ln(D)
    return p


def init_clip_text(cfg: CLIPTextConfig, generator: torch.Generator, device="cuda") -> dict:
    """Seeded random parameters of ``CLIPTextEncoder(cfg)`` on ``device``."""
    init = _Init(generator, resolve_device(device))
    D, I = cfg.hidden_size, cfg.intermediate_size
    p = {"token_embedding": init.embed(cfg.vocab_size, D),
         "position_embedding": init.embed(cfg.max_positions, D)}
    for i in range(cfg.n_layer):
        p[f"layer{i}"] = {"layer_norm1": init.ln(D),
                          **{n: init.dense(D, D) for n in ("q_proj", "k_proj", "v_proj",
                                                           "out_proj")},
                          "layer_norm2": init.ln(D), "fc1": init.dense(D, I),
                          "fc2": init.dense(I, D)}
    p["final_layer_norm"] = init.ln(D)
    return p


# -- HF-layout converters --------------------------------------------------------


def _ln_params(sd, src):
    return {"scale": sd[src + ".weight"], "bias": sd[src + ".bias"]}


def convert_gpt2_encoder(state_dict: Mapping, cfg: GPT2EncoderConfig, device="cuda") -> dict:
    """HF ``GPT2Model``/``GPT2LMHeadModel`` state dict (keys with or without
    ``transformer.``) -> ``{"params": ...}``; HF's ``Conv1D`` weights are
    already ``[in, out]``. The LM head is ignored."""
    sd = state_dict_tensors({k.removeprefix("transformer."): v for k, v in state_dict.items()},
                            resolve_device(device))

    def conv1d(src):
        return {"kernel": sd[src + ".weight"], "bias": sd[src + ".bias"]}

    p = {"wte": {"embedding": sd["wte.weight"]}, "wpe": {"embedding": sd["wpe.weight"]},
         "ln_f": _ln_params(sd, "ln_f")}
    for i in range(cfg.n_layer):
        src = f"h.{i}"
        p[f"h{i}"] = {"ln_1": _ln_params(sd, f"{src}.ln_1"), "ln_2": _ln_params(sd, f"{src}.ln_2"),
                      "c_attn": conv1d(f"{src}.attn.c_attn"),
                      "c_proj": conv1d(f"{src}.attn.c_proj"),
                      "c_fc": conv1d(f"{src}.mlp.c_fc"),
                      "mlp_proj": conv1d(f"{src}.mlp.c_proj")}
    return {"params": p}


def convert_clip_text(state_dict: Mapping, cfg: CLIPTextConfig, device="cuda") -> dict:
    """HF ``CLIPTextModel`` state dict (keys with or without ``text_model.``)
    -> ``{"params": ...}``; ``Linear`` weights ``[out, in]`` transposed."""
    from zs_aac_tpu_torch.models.convert import linear_kernel

    sd = state_dict_tensors({k.removeprefix("text_model."): v for k, v in state_dict.items()},
                            resolve_device(device))

    def dense(src):
        return {"kernel": linear_kernel(sd[src + ".weight"]), "bias": sd[src + ".bias"]}

    p = {"token_embedding": {"embedding": sd["embeddings.token_embedding.weight"]},
         "position_embedding": {"embedding": sd["embeddings.position_embedding.weight"]},
         "final_layer_norm": _ln_params(sd, "final_layer_norm")}
    for i in range(cfg.n_layer):
        src = f"encoder.layers.{i}"
        p[f"layer{i}"] = {
            "layer_norm1": _ln_params(sd, f"{src}.layer_norm1"),
            "layer_norm2": _ln_params(sd, f"{src}.layer_norm2"),
            **{n: dense(f"{src}.self_attn.{n}") for n in ("q_proj", "k_proj", "v_proj",
                                                           "out_proj")},
            "fc1": dense(f"{src}.mlp.fc1"), "fc2": dense(f"{src}.mlp.fc2"),
        }
    return {"params": p}
