"""int8 (w8a8) BERT text tower for MAGIC's ``--q8_tower``.

The counterpart of the JAX package's ``models/bert_q8.py``: per-output-column
symmetric int8 weights, per-row dynamic int8 activations and int8 x int8
GEMMs with int32 accumulation (``models.gpt2._int8_dot``, ``torch._int_mm``),
an fp32 rescale; embeddings and LayerNorms stay float, and the activations
are ``compute_dtype`` (bf16 by default, as in JAX) between the GEMMs.

It is an approximate mode: 8-bit activations perturb the CLAP scores. The
JAX package bounds it by the cosine of its embeddings to the float tower's
(>= 0.98, ``tests/test_bert_q8.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.bert import BertConfig
from zs_aac_tpu_torch.models.gpt2 import _int8_dot
from zs_aac_tpu_torch.ops.quant import div

__all__ = ["quantize_text_tower_int8", "encode_text_q8"]


def _q(dense: dict) -> dict:
    """{"kernel" [in, out], "bias"} -> per-output-column int8."""
    w = dense["kernel"].float()
    scale = div(torch.clamp_min(w.abs().amax(dim=0), 1e-8), 127.0)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w": wq, "scale_a8": scale, "b": dense["bias"].float()}


def quantize_text_tower_int8(variables: dict, cfg: BertConfig) -> dict:
    """ASE variables (``params/text_enc``, a ``BertEncoder`` tree, and
    ``params/text_proj``) -> the int8 serving tree; the audio tower is
    dropped (the MAGIC scorer encodes text only)."""
    p = variables["params"]
    te = p["text_enc"]
    layers = []
    for i in range(cfg.num_hidden_layers):
        l = te[f"layer{i}"]
        layers.append({
            "q": _q(l["self"]["query"]), "k": _q(l["self"]["key"]),
            "v": _q(l["self"]["value"]), "o": _q(l["attn_out"]),
            "attn_ln": l["attn_ln"],
            "mid": _q(l["intermediate"]), "out": _q(l["output"]),
            "out_ln": l["out_ln"],
        })
    proj = p["text_proj"]
    return {
        "word": te["word_embeddings"]["embedding"],
        "pos": te["position_embeddings"]["embedding"],
        "type": te["token_type_embeddings"]["embedding"],
        "emb_ln": te["emb_ln"],
        "layers": layers,
        "fc1": _q(proj["fc1"]), "fc2": _q(proj["fc2"]),
    }


def _ln(x, p, eps):
    """LayerNorm in fp32, the JAX ``bert_q8._ln`` formula."""
    x = x.float()
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * p["scale"] + p["bias"]


def _dense(x, q):
    return _int8_dot(x, q["w"], q["scale_a8"], x.dtype) + q["b"].to(x.dtype)


def encode_text_q8(qt: dict, cfg: BertConfig, ids, compute_dtype=torch.bfloat16):
    """[n, L] ids (0 = pad) -> [n, E] L2-normalized CLAP text embeddings
    (fp32): the w8a8 twin of ``ASE.encode_text`` over a ``BertEncoder``
    tower (post-LN, additive -1e9 mask bias, [CLS] pooling, Linear-ReLU-
    Linear projection)."""
    c = cfg
    ids = ids.long()
    n, L = ids.shape
    h, d = c.num_attention_heads, c.hidden_size // c.num_attention_heads
    bias = torch.where(ids[:, None, None, :] != 0, 0.0, -1e9)

    x = qt["word"][ids] + qt["pos"][None, :L] + qt["type"][0][None, None]
    x = _ln(x, qt["emb_ln"], c.layer_norm_eps).to(compute_dtype)
    inv_sqrt_d = float(1.0 / math.sqrt(d))
    for l in qt["layers"]:
        q, k, v = (_dense(x, l[name]).reshape(n, L, h, d).transpose(1, 2)
                   for name in ("q", "k", "v"))
        att = (q @ k.transpose(-1, -2)).float()
        att = torch.softmax(att * inv_sqrt_d + bias, dim=-1).to(x.dtype)
        a = (att @ v).transpose(1, 2).reshape(n, L, c.hidden_size)
        x = _ln(x + _dense(a, l["o"]), l["attn_ln"], c.layer_norm_eps).to(compute_dtype)
        f = F.gelu(_dense(x, l["mid"]).float()).to(compute_dtype)
        x = _ln(x + _dense(f, l["out"]), l["out_ln"], c.layer_norm_eps).to(compute_dtype)

    y = torch.relu(_dense(x[:, 0], qt["fc1"]))
    y = _dense(y, qt["fc2"]).float()
    return y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-12)
