"""Plain reference of the ``mistral7b-lora`` configuration: the multilingual
captioner (the MLP mapper, Mistral-7B-v0.1 with LoRA r=8 at every site),
served as w8a8 base weights with an int8 KV cache.

float32 with TF32 off, one layer at a time. It follows Mistral (RMSNorm,
rotate-half RoPE, grouped-query attention, SwiGLU; the 4096-row sliding
window is longer than any sequence here) with LoRA unmerged (``(x @ a) @ b
* alpha / r`` beside every base product, the lm_head's too) and states the
serving precision itself:

- every base product (q/k/v/o, gate/up/down, lm_head) is W8A8: weights
  quantized per output column from the bf16 weights, activations per row;
- the prompt's positions attend over their float keys and values; every
  generated position over keys (after RoPE) and values quantized per
  (row, kv head, position) vector, its own row included.

``bits=4`` puts every one of those quantizations at 4 bits: the control of
the caption cell's check. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.common import (div, quant_cols, quant_rows, qmatmul, seeded_leaves,
                                        strict_fp32, sub_seed)

BASE_STREAM, HEAD_STREAM = 1, 2
SITES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _site_dims(cfg):
    D, I = cfg["hidden_size"], cfg["intermediate_size"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    return {"wq": (D, D), "wk": (D, kvd), "wv": (D, kvd), "wo": (D, D),
            "gate": (D, I), "up": (D, I), "down": (I, D)}


def make_caption_weights(cfg, seed: int, device) -> dict:
    """The captioner's weights from ``seed``, in two draws on ``device``:
    the base in bf16, the dtype it is stored and served from (matrices and
    embeddings N(0, 0.02)), and in float32 the RMSNorm scales (1 + N(0,
    0.1)), LoRA (``a`` and ``b`` N(0, 0.02): a trained adapter, so that it
    moves the logits) and the mapper (N(0, 0.02), biases too).

    ``{"mapper": [{"w" [in, out], "b"}], "embed" [V, D], "layers": [{"attn":
    {"wq", "wk", "wv", "wo"}, "mlp": {"gate", "up", "down"}, "ln1", "ln2"}],
    "norm", "lm_head" [D, V], "lora": {"layers": [{site: {"a", "b"}}],
    "lm_head": {"a", "b"}, "r", "alpha"}}`` (weights [in, out])."""
    D, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    dims = _site_dims(cfg)
    base = [("embed", (V, D), 0.0, 0.02)]
    for i in range(L):
        base += [(f"{i}.{n}", dims[n], 0.0, 0.02) for n in SITES]
    base += [("lm_head", (D, V), 0.0, 0.02)]
    b = seeded_leaves(base, sub_seed(seed, BASE_STREAM), device, torch.bfloat16)
    r = cfg["lora"]["r"]
    head = [(f"{i}.ln{j}", (D,), 1.0, 0.1) for i in range(L) for j in (1, 2)]
    head += [("norm", (D,), 1.0, 0.1)]
    for i in range(L):
        for n in SITES:
            a_in, a_out = dims[n]
            head += [(f"lora.{i}.{n}.a", (a_in, r), 0.0, 0.02),
                     (f"lora.{i}.{n}.b", (r, a_out), 0.0, 0.02)]
    head += [("lora.lm_head.a", (D, r), 0.0, 0.02), ("lora.lm_head.b", (r, V), 0.0, 0.02)]
    sizes = cfg["mapper"]["sizes"]
    for i, (a_in, a_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        head += [(f"mapper.{i}.w", (a_in, a_out), 0.0, 0.02), (f"mapper.{i}.b", (a_out,), 0.0, 0.02)]
    h = seeded_leaves(head, sub_seed(seed, HEAD_STREAM), device)
    dev = torch.device(device)
    return {
        "mapper": [{"w": h[f"mapper.{i}.w"], "b": h[f"mapper.{i}.b"]}
                   for i in range(len(sizes) - 1)],
        "embed": b["embed"],
        "layers": [{"attn": {n: b[f"{i}.{n}"] for n in ("wq", "wk", "wv", "wo")},
                    "mlp": {n: b[f"{i}.{n}"] for n in ("gate", "up", "down")},
                    "ln1": h[f"{i}.ln1"], "ln2": h[f"{i}.ln2"]} for i in range(L)],
        "norm": h["norm"],
        "lm_head": b["lm_head"],
        "lora": {"layers": [{n: {"a": h[f"lora.{i}.{n}.a"], "b": h[f"lora.{i}.{n}.b"]}
                             for n in SITES} for i in range(L)],
                 "lm_head": {"a": h["lora.lm_head.a"], "b": h["lora.lm_head.b"]},
                 "r": torch.tensor(float(r), device=dev),
                 "alpha": torch.tensor(float(cfg["lora"]["alpha"]), device=dev)},
    }


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope_tables(d, T, theta, device):
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    ang = torch.arange(T, device=device, dtype=torch.float64)[:, None] * \
        torch.from_numpy(inv).to(device)[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    return torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)


def _rope(x, cos, sin):
    d = x.shape[-1]
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def mapper_prefix(weights, cfg, prefixes):
    h = prefixes.float()
    layers = weights["mapper"]
    for i, p in enumerate(layers):
        h = h @ p["w"] + p["b"]
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h.reshape(h.shape[0], cfg["mapper"]["prefix_length"], cfg["hidden_size"])


@torch.no_grad()
def caption_logits(weights, cfg, prefixes, tokens, bits: int = 8, act_dtype=None):
    """Teacher-forced logits of greedy captions: the prompt is [mapper
    prefix | the language tag's tokens], then the served tokens. ``tokens``
    [S, N]; returns fp32 logits [S, N, vocab], row ``i`` the distribution
    the decode chose token ``i`` from.

    ``act_dtype`` (a witness, not the check): round the residual stream and
    every product's input and output to that dtype, as a server with
    activations in it would hold them."""
    strict_fp32()

    def rnd(t):
        return t if act_dtype is None else t.to(act_dtype).float()

    S, N = tokens.shape
    D, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    dev = prefixes.device
    lora = weights["lora"]
    ls = (lora["alpha"] / lora["r"]).float()
    tags = torch.tensor(cfg["serving"]["tag_ids"], device=dev)[None].expand(S, -1)
    emb = weights["embed"]
    x = torch.cat([mapper_prefix(weights, cfg, prefixes),
                   emb[tags].float(), emb[tokens[:, :N - 1]].float()], 1)
    x = rnd(x)
    Lp = x.shape[1] - (N - 1)
    T = x.shape[1]
    cos, sin = _rope_tables(d, T, cfg["rope_theta"], dev)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    prompt = (torch.arange(T, device=dev) < Lp)[:, None]
    rep = H // KV

    def lin(h, w, site):
        h = rnd(h)
        wq, ws = quant_cols(w, bits)
        out = qmatmul(h, wq, ws, bits)
        del wq
        return rnd(out + (h @ site["a"]) @ site["b"] * ls)

    for i, p in enumerate(weights["layers"]):
        ll = lora["layers"][i]
        h = _rms(x, p["ln1"], eps)
        q = lin(h, p["attn"]["wq"], ll["wq"]).reshape(S, T, H, d).transpose(1, 2)
        k = lin(h, p["attn"]["wk"], ll["wk"]).reshape(S, T, KV, d).transpose(1, 2)
        v = lin(h, p["attn"]["wv"], ll["wv"]).reshape(S, T, KV, d).transpose(1, 2)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)
        k8, sk = quant_rows(k, bits)
        v8, sv = quant_rows(v, bits)
        k, v, k8, v8, sk, sv = (t.repeat_interleave(rep, dim=1) for t in (k, v, k8, v8, sk, sv))
        sf = div(q @ k.transpose(-1, -2), math.sqrt(d))
        of = torch.softmax(sf.masked_fill(~causal, -math.inf), -1) @ v
        sq = (q @ k8.transpose(-1, -2)) * div(sk.transpose(-1, -2), math.sqrt(d))
        pq = torch.softmax(sq.masked_fill(~causal, -math.inf), -1) * sv.transpose(-1, -2)
        o = torch.where(prompt, of, pq @ v8).transpose(1, 2).reshape(S, T, H * d)
        x = rnd(x + lin(o, p["attn"]["wo"], ll["wo"]))
        h = _rms(x, p["ln2"], eps)
        g = lin(h, p["mlp"]["gate"], ll["gate"])
        u = lin(h, p["mlp"]["up"], ll["up"])
        x = rnd(x + lin(torch.nn.functional.silu(g) * u, p["mlp"]["down"], ll["down"]))
    x = _rms(x[:, Lp - 1:], weights["norm"], eps)
    return lin(x, weights["lm_head"], lora["lm_head"])
