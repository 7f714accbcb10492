"""Mistral-7B decoder with LoRA, KV-cached, in PyTorch.

The counterpart of the JAX package's ``models/mistral.py``: pure functions
over a parameter dictionary shaped like the JAX pytree (weights ``[in,
out]``; ``"layers"`` a list of per-layer dicts). RMSNorm, rotary embeddings
(rotate-half), grouped-query attention (32 q / 8 kv heads at 7B), SwiGLU, a
sliding-window causal mask. LoRA (PEFT layout ``a`` [in, r], ``b`` [r, out],
scale ``alpha / r``) is applied at the matmul sites and never merged, over a
float base or an int8 one (``quantize_mistral_int8``: w8, or w8a8 through
``torch._int_mm``; ``fuse=True`` for the ``wqkv``/``gateup`` serving
layout).

Two caches, as in the JAX package: a float cache ``{"k", "v"}`` stacked over
layers, ``[n_layers, B, KV, T, d]``, and an int8 cache, per layer ``(k, v,
k_scale, v_scale)`` with batch and kv-head folded, ``[B*KV, T, d]`` int8 and
``[B*KV, T]`` fp32 scales, whose scales fold into the scores and the
probabilities. Departures from the JAX functions, all exact:

- the caches are updated in place (the JAX versions return new arrays);
- a decode step attends over the rows its window keeps only
  (``index - sliding_window < t <= index``): the JAX step masks the rest to
  -1e9, which gives them an exact 0 weight;
- the prefill writes the prompt's rows only;
- the int8 ``lm_head`` is padded to a multiple of 8 columns (zero columns,
  scale 1), because ``torch._int_mm`` on CUDA wants N % 8 == 0; the logits
  are sliced back to the vocabulary;
- int8 weights keep the JAX shape ``[in, out]`` in column-major memory (the
  transpose of a contiguous ``[out, in]``): ``torch._int_mm`` on the H100
  runs 5-13x faster with its second operand column-major than row-major at
  the decode's shapes (NVIDIA H100 80GB HBM3, 700.00 W;
  ``examples/probe_int_mm.py``).

Operation order follows the JAX functions: RMSNorm casts to the input dtype
before ``* w``; the full-sequence scores are in the activation dtype with
the softmax in fp32; the float step's scores are cast to fp32 before the
``/ sqrt(d)``; the int8 step's two products accumulate and stay in fp32.
Every division by a constant is by a tensor (``ops/quant.py``). No Pallas
kernel is on this path: the matmuls are cuBLAS's (and ``torch._int_mm``).

Tensor parallelism (Megatron's, float weights and the float cache):
``mistral_embed``, ``mistral_forward``, ``init_mistral_cache``,
``mistral_prefill`` and ``mistral_step`` take ``tp``, the ``model`` axis of a
mesh, with ``params`` and ``lora`` this rank's shards
(``parallel.tp.shard_mistral_params``, ``shard_mistral_lora``): f before
the column-parallel sites (q/k/v by heads, gate/up, lm_head by vocabulary),
g after the row-parallel ones (wo, down) with each LoRA delta in the
partial sum, the vocabulary-parallel embedding, and the logits gathered
whole. The fused ``wqkv``/``gateup`` leaves raise under ``tp``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.gpt2 import _int8_dot
from zs_aac_tpu_torch.ops.quant import div, quantize_vec
from zs_aac_tpu_torch.parallel.mesh import tp_copy, tp_gather, tp_reduce
from zs_aac_tpu_torch.parallel.tp import embed_lookup
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = [
    "MistralConfig",
    "init_mistral",
    "convert_mistral",
    "init_lora",
    "lora_trainable_mask",
    "mistral_embed",
    "mistral_forward",
    "init_mistral_cache",
    "init_mistral_cache_q8",
    "mistral_prefill",
    "mistral_step",
    "quantize_mistral_int8",
]

@dataclasses.dataclass(frozen=True)
class MistralConfig:
    """Defaults: ``mistralai/Mistral-7B-v0.1``'s ``config.json``."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: int = 4096
    max_positions: int = 4096

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_heads


def _rms_norm(x, w, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


@functools.lru_cache(maxsize=None)
def _inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's inverse frequencies in float32 numpy, as the JAX function
    computes them, moved to ``device`` once (a copy from host memory each
    step would wait for the device)."""
    inv = 1.0 / (theta ** (np.arange(0, d, 2, np.float32) / d))
    return torch.from_numpy(inv).to(device)


def _rope_tables(d: int, positions: torch.Tensor, theta: float, dtype):
    """cos and sin [L, d] in ``dtype``."""
    ang = positions[:, None].float() * _inv_freq(d, theta, positions.device)[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1).to(dtype), torch.cat([sin, sin], dim=-1).to(dtype)


def _rope(x, tables):
    """x: [B, H, L, d]; rotate-half RoPE (HF Llama/Mistral convention)."""
    cos, sin = tables
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _base_matmul(x, w):
    """``x @ w`` for a float weight or an int8 one: {"w" int8 [in, out],
    "scale" fp32 [out]} dequantizes in the matmul (w8); {"w", "scale_a8"}
    quantizes the activations per row and runs an int8 GEMM (w8a8)."""
    if isinstance(w, dict):
        if "scale_a8" in w:
            return _int8_dot(x, w["w"], w["scale_a8"], x.dtype)
        return (x @ w["w"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def _lora_delta(x, lora: Dict, scale, tp=None, row=False):
    """``(x @ a) @ b * scale``. Under ``tp`` the factor that stays whole (a
    at a column-parallel site, b at a row-parallel one) passes through f, so
    its gradient sums the group's partial ones."""
    a, b = lora["a"].to(x.dtype), lora["b"].to(x.dtype)
    if row:
        b = tp_copy(b, tp)
    else:
        a = tp_copy(a, tp)
    return ((x @ a) @ b) * scale


def _lora_matmul(x, w, lora: Optional[Dict], scale, tp=None, row=False):
    """``x @ w`` plus the low-rank path ``(x @ a) @ b * scale``; LoRA
    parameters are kept fp32 and cast to the activation dtype at use. Under
    ``tp`` a row-parallel site (``row``) sums base and delta over the group
    (g); a column-parallel site's ``x`` has passed f."""
    out = _base_matmul(x, w)
    if lora is not None:
        out = out + _lora_delta(x, lora, scale, tp, row)
    return tp_reduce(out, tp) if row else out


def _local(n: int, tp) -> int:
    """This rank's share of ``n`` heads under ``tp``."""
    return n // (tp.size if tp is not None else 1)


def _fused(layer: Dict, name: str, tp) -> bool:
    """Whether ``layer`` holds the fused serving leaf ``name``; it refuses ``tp``."""
    if tp is not None and name in layer:
        raise ValueError(f"the fused {name!r} serving leaf is not tensor-parallel; "
                         "shard the unfused weights (parallel.tp.shard_mistral_params)")
    return name in layer


def _site(lora, name):
    return lora.get(name) if lora else None


def _qkv_matmul(a, cfg: MistralConfig, x, lora: Optional[Dict], scale, tp=None):
    """q/k/v projections -> (q, k, v). Reads the fused ``wqkv`` leaf when
    present (one GEMM and one activation quantization instead of three),
    with the LoRA deltas per site on the slices."""
    if _fused(a, "wqkv", tp):
        D = cfg.hidden_size
        kvd = cfg.n_kv_heads * cfg.head_dim
        qkv = _base_matmul(x, a["wqkv"])
        q, k, v = qkv[..., :D], qkv[..., D:D + kvd], qkv[..., D + kvd:]
        if lora is not None:
            if "wq" in lora:
                q = q + _lora_delta(x, lora["wq"], scale)
            if "wk" in lora:
                k = k + _lora_delta(x, lora["wk"], scale)
            if "wv" in lora:
                v = v + _lora_delta(x, lora["wv"], scale)
        return q, k, v
    x = tp_copy(x, tp)
    return tuple(_lora_matmul(x, a[n], _site(lora, n), scale, tp) for n in ("wq", "wk", "wv"))


def _mlp(p, x, lora, scale, tp=None):
    if _fused(p, "gateup", tp):   # fused serving layout (quantize_mistral_int8)
        I = p["gateup"]["w"].shape[1] // 2
        gu = _base_matmul(x, p["gateup"])
        g, u = gu[..., :I], gu[..., I:]
        if lora is not None:
            if "gate" in lora:
                g = g + _lora_delta(x, lora["gate"], scale)
            if "up" in lora:
                u = u + _lora_delta(x, lora["up"], scale)
    else:
        x = tp_copy(x, tp)
        g = _lora_matmul(x, p["gate"], _site(lora, "gate"), scale, tp)
        u = _lora_matmul(x, p["up"], _site(lora, "up"), scale, tp)
    return _lora_matmul(F.silu(g) * u, p["down"], _site(lora, "down"), scale, tp, row=True)


def _head(params, cfg: MistralConfig, x, lora, scale, tp=None):
    """Final RMSNorm and the (LoRA'd) lm_head -> logits [..., vocab]; under
    ``tp`` this rank's vocabulary columns, gathered whole."""
    x = _rms_norm(x, params["norm"], cfg.rms_norm_eps)
    head = _site(lora, "lm_head")
    if tp is not None:
        x = tp_copy(x, tp)
        out = x @ params["lm_head"]
        if head is not None:
            out = out + _lora_delta(x, head, scale, tp)
        return tp_gather(out, tp)[..., :cfg.vocab_size]
    out = _base_matmul(x, params["lm_head"])[..., :cfg.vocab_size]
    if head is not None:
        out = out + _lora_delta(x, head, scale)
    return out


def _pad_cols(w, scale):
    """Pad an int8 weight to a multiple of 8 columns (zero columns, scale 1)."""
    pad = -w.shape[1] % 8
    if pad:
        w = F.pad(w, (0, pad))
        scale = F.pad(scale, (0, pad), value=1.0)
    return w, scale


def col_major(w):
    """``w`` [in, out] with the same values in column-major memory."""
    return w.t().contiguous().t()


def quantize_mistral_int8(params: dict, mode: str = "w8", fuse: bool = False) -> dict:
    """Per-output-channel symmetric int8 weights of every projection
    (q/k/v/o/gate/up/down/lm_head); ``embed`` and the RMSNorm scales stay
    float. ``mode``: ``"w8"`` (dequantize in the matmul) or ``"w8a8"`` (int8
    GEMMs). ``fuse=True`` emits the serving layout: q/k/v concatenated into
    one ``wqkv`` [D, D + 2 kvd] and gate/up into ``gateup`` [D, 2I], the
    per-column scales concatenated with the columns (the same int8 values
    and scales as unfused). The ``lm_head`` copy is padded (module
    docstring). One weight is widened to fp32 at a time."""
    assert mode in ("w8", "w8a8"), mode
    skey = "scale" if mode == "w8" else "scale_a8"

    def q(w):
        w = w.float()
        scale = div(torch.clamp_min(w.abs().amax(dim=0), 1e-8), 127.0)
        wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"w": col_major(wq), skey: scale}

    def qcat(*ws):
        qs = [q(w) for w in ws]
        return {"w": col_major(torch.cat([e["w"] for e in qs], dim=1)),
                skey: torch.cat([e[skey] for e in qs])}

    layers = []
    for lp in params["layers"]:
        a, m = lp["attn"], lp["mlp"]
        if fuse:
            attn = {"wqkv": qcat(a["wq"], a["wk"], a["wv"]), "wo": q(a["wo"])}
            mlp = {"gateup": qcat(m["gate"], m["up"]), "down": q(m["down"])}
        else:
            attn = {k: q(a[k]) for k in ("wq", "wk", "wv", "wo")}
            mlp = {k: q(m[k]) for k in ("gate", "up", "down")}
        layers.append({"attn": attn, "mlp": mlp, "ln1": lp["ln1"], "ln2": lp["ln2"]})
    head = q(params["lm_head"])
    head["w"], head[skey] = _pad_cols(head["w"], head[skey])
    head["w"] = col_major(head["w"])
    return {"embed": params["embed"], "layers": layers, "norm": params["norm"],
            "lm_head": head}


def _attention(p, cfg: MistralConfig, x, *, bias, tables, lora, scale, tp=None):
    """Full-sequence (forward/prefill) attention -> (out, (k, v)), k/v
    [B, KV, L, d] after RoPE (this rank's heads under ``tp``)."""
    B, L, _ = x.shape
    H, KV, d = _local(cfg.n_heads, tp), _local(cfg.n_kv_heads, tp), cfg.head_dim
    q, k, v = _qkv_matmul(p, cfg, x, lora, scale, tp)
    q = _rope(q.reshape(B, L, H, d).transpose(1, 2), tables)
    k = _rope(k.reshape(B, L, KV, d).transpose(1, 2), tables)
    v = v.reshape(B, L, KV, d).transpose(1, 2)
    rep = H // KV
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    att = div(q @ kr.transpose(-1, -2), math.sqrt(d))
    att = torch.softmax((att + bias).float(), dim=-1).to(x.dtype)
    o = (att @ vr).transpose(1, 2).reshape(B, L, H * d)
    return _lora_matmul(o, p["wo"], _site(lora, "wo"), scale, tp, row=True), (k, v)


def _causal_bias(L, offset, window, dtype, device):
    q = torch.arange(L, device=device)[:, None] + offset
    kpos = torch.arange(L, device=device)[None, :]
    ok = (kpos <= q) & (kpos > q - window)
    return torch.where(ok, 0.0, -1e9).to(dtype)[None, None]


def mistral_embed(params, tokens, tp=None):
    return embed_lookup(params["embed"], tokens, tp)


def _lora_layer(lora, i):
    return None if lora is None else lora["layers"][i]


def _lora_scale(lora, dtype):
    """``alpha / r`` (0-d fp32 leaves) divided in fp32, then cast to the
    activation dtype, as the JAX ``_lora_delta`` casts it."""
    return None if lora is None else (lora["alpha"] / lora["r"]).to(dtype)


def _decoder(params, cfg, x, bias, lora, scale, on_kv=None, tp=None):
    """The decoder stack over a full sequence -> final hidden states;
    ``on_kv(i, k, v)`` receives each layer's K/V ([B, KV, L, d], after
    RoPE)."""
    L = x.shape[1]
    tables = _rope_tables(cfg.head_dim, torch.arange(L, device=x.device), cfg.rope_theta,
                          x.dtype)
    for i, p in enumerate(params["layers"]):
        ll = _lora_layer(lora, i)
        h = _rms_norm(x, p["ln1"], cfg.rms_norm_eps)
        a, (k, v) = _attention(p["attn"], cfg, h, bias=bias, tables=tables, lora=ll,
                               scale=scale, tp=tp)
        if on_kv is not None:
            on_kv(i, k, v)
        x = x + a
        h = _rms_norm(x, p["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(p["mlp"], h, ll, scale, tp)
    return x


def mistral_forward(params, cfg: MistralConfig, inputs_embeds, attention_mask=None,
                    lora=None, tp=None):
    """Full-sequence forward -> logits [B, L, vocab]; ``attention_mask``
    [B, L] is 1 where a position is kept; ``tp`` as in the module
    docstring."""
    B, L, _ = inputs_embeds.shape
    x = inputs_embeds
    bias = _causal_bias(L, 0, cfg.sliding_window, x.dtype, x.device)
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).to(x.dtype)
    scale = _lora_scale(lora, x.dtype)
    x = _decoder(params, cfg, x, bias, lora, scale, tp=tp)
    return _head(params, cfg, x, lora, scale, tp)


def init_mistral_cache(cfg: MistralConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cuda", tp=None):
    """Float cache: k/v stacked over layers, [n_layers, B, KV, T, d] (KV
    this rank's kv heads under ``tp``)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, _local(cfg.n_kv_heads, tp), max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_mistral_cache_q8(cfg: MistralConfig, batch: int, max_len: int, device="cuda"):
    """int8 cache: per layer (k, v, k_scale, v_scale), k/v [B*KV, T, d]
    int8, scales [B*KV, T] fp32 (one per (row, kv head, position))."""
    dev = resolve_device(device)
    bg = batch * cfg.n_kv_heads
    return tuple(
        (torch.zeros(bg, max_len, cfg.head_dim, dtype=torch.int8, device=dev),
         torch.zeros(bg, max_len, cfg.head_dim, dtype=torch.int8, device=dev),
         torch.zeros(bg, max_len, dtype=torch.float32, device=dev),
         torch.zeros(bg, max_len, dtype=torch.float32, device=dev))
        for _ in range(cfg.n_layers))


def mistral_prefill(params, cfg: MistralConfig, inputs_embeds, cache, lora=None, tp=None):
    """Run the prompt, writing its K/V into rows ``0..L-1`` of the cache in
    place (quantized per vector for the int8 cache). Returns (logits
    [B, L, vocab], cache)."""
    B, L, _ = inputs_embeds.shape
    x = inputs_embeds
    bias = _causal_bias(L, 0, cfg.sliding_window, x.dtype, x.device)
    scale = _lora_scale(lora, x.dtype)
    q8 = _q8_cache(cache, tp)
    bg, d = B * cfg.n_kv_heads, cfg.head_dim

    def on_kv(i, k, v):
        if q8:
            ck, cv, sk, sv = cache[i]
            qk, s_k = quantize_vec(k.float())
            qv, s_v = quantize_vec(v.float())
            ck[:, :L] = qk.reshape(bg, L, d)
            cv[:, :L] = qv.reshape(bg, L, d)
            sk[:, :L] = s_k.reshape(bg, L)
            sv[:, :L] = s_v.reshape(bg, L)
        else:
            cache["k"][i, :, :, :L] = k
            cache["v"][i, :, :, :L] = v

    x = _decoder(params, cfg, x, bias, lora, scale, on_kv, tp)
    return _head(params, cfg, x, lora, scale, tp), cache


def _q8_cache(cache, tp) -> bool:
    q8 = isinstance(cache, tuple)
    if q8 and tp is not None:
        raise ValueError("the int8 KV cache is not tensor-parallel; use the float cache")
    return q8


def mistral_step(params, cfg: MistralConfig, x_embed, cache, index: int, lora=None, tp=None):
    """One cached decode step for the token at position ``index``.
    ``x_embed``: [B, D]. Writes its K/V into row ``index`` of the cache in
    place; GQA is grouped (each kv head serves its ``H / KV`` query heads
    without a copy of the cache). Returns (logits [B, vocab], cache)."""
    B, D = x_embed.shape
    H, KV, d = _local(cfg.n_heads, tp), _local(cfg.n_kv_heads, tp), cfg.head_dim
    rep, bg = H // KV, B * KV
    lo, hi = max(0, index - cfg.sliding_window + 1), index + 1
    x = x_embed[:, None]
    tables = _rope_tables(d, torch.full((1,), index, device=x.device), cfg.rope_theta, x.dtype)
    scale = _lora_scale(lora, x.dtype)
    sqrt_d = math.sqrt(d)
    q8 = _q8_cache(cache, tp)
    for i, p in enumerate(params["layers"]):
        ll = _lora_layer(lora, i)
        a = p["attn"]
        h = _rms_norm(x, p["ln1"], cfg.rms_norm_eps)
        q, k, v = _qkv_matmul(a, cfg, h, ll, scale, tp)
        q = _rope(q.reshape(B, 1, H, d).transpose(1, 2), tables)     # [B, H, 1, d]
        k = _rope(k.reshape(B, 1, KV, d).transpose(1, 2), tables)    # [B, KV, 1, d]
        if q8:
            ck, cv, sk, sv = cache[i]
            qk, s_k = quantize_vec(k[:, :, 0].float())
            qv, s_v = quantize_vec(v.reshape(B, KV, d).float())
            ck[:, index] = qk.reshape(bg, d)
            cv[:, index] = qv.reshape(bg, d)
            sk[:, index] = s_k.reshape(bg)
            sv[:, index] = s_v.reshape(bg)
            # int8 x activation products accumulate and stay in fp32 (the
            # JAX step's preferred_element_type), scales folded in
            qg = q[:, :, 0].reshape(bg, rep, d).float()
            att = torch.bmm(qg, ck[:, lo:hi].float().transpose(1, 2))       # [BG, rep, n]
            att = att * div(sk[:, None, lo:hi], sqrt_d)
            att = torch.softmax(att, dim=-1)
            att = (att * sv[:, None, lo:hi]).to(x.dtype)
            o = torch.bmm(att.float(), cv[:, lo:hi].float())               # [BG, rep, d]
            o = o.to(x.dtype).reshape(B, 1, H * d)
        else:
            ck, cv = cache["k"][i], cache["v"][i]                            # [B, KV, T, d]
            ck[:, :, index] = k[:, :, 0].to(ck.dtype)
            cv[:, :, index] = v.reshape(B, KV, d).to(cv.dtype)
            qg = q[:, :, 0].reshape(B, KV, rep, d)
            att = qg @ ck[:, :, lo:hi].to(x.dtype).transpose(-1, -2)        # [B, KV, rep, n]
            att = torch.softmax(div(att.float(), sqrt_d), dim=-1).to(x.dtype)
            o = (att @ cv[:, :, lo:hi].to(x.dtype)).reshape(B, 1, H * d)
        x = x + _lora_matmul(o, a["wo"], _site(ll, "wo"), scale, tp, row=True)
        h = _rms_norm(x, p["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(p["mlp"], h, ll, scale, tp)
    return _head(params, cfg, x, lora, scale, tp)[:, 0], cache


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_mistral(cfg: MistralConfig, seed: int = 0, device="cuda",
                 dtype=torch.bfloat16) -> dict:
    """Random init (matrices ~ N(0, 0.02), RMSNorm scales 1) drawn directly
    in ``dtype`` on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, one matrix at a time (no fp32 copy of a 7B base). The draws
    are not ``jax.random``'s."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def nrm(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype).mul_(0.02)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    D, I = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    embed = nrm(cfg.vocab_size, D)
    lm_head = nrm(D, cfg.vocab_size)
    layers = [{"attn": {"wq": nrm(D, D), "wk": nrm(D, kvd), "wv": nrm(D, kvd), "wo": nrm(D, D)},
               "mlp": {"gate": nrm(D, I), "up": nrm(D, I), "down": nrm(I, D)},
               "ln1": ones(D), "ln2": ones(D)}
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "norm": ones(D), "lm_head": lm_head}


def convert_mistral(state_dict, cfg: MistralConfig, device="cuda", dtype=torch.float32) -> dict:
    """HF ``MistralForCausalLM`` state dict (torch tensors or numpy arrays)
    -> the parameter dict, weights transposed to [in, out]."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): torch.as_tensor(np.asarray(v) if not
                                                   isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}

    def t(name):
        return sd[name].t().contiguous().to(device=dev, dtype=dtype)

    def vec(name):
        return sd[name].to(device=dev, dtype=dtype)

    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}"
        layers.append({
            "attn": {"wq": t(f"{p}.self_attn.q_proj.weight"),
                     "wk": t(f"{p}.self_attn.k_proj.weight"),
                     "wv": t(f"{p}.self_attn.v_proj.weight"),
                     "wo": t(f"{p}.self_attn.o_proj.weight")},
            "mlp": {"gate": t(f"{p}.mlp.gate_proj.weight"),
                    "up": t(f"{p}.mlp.up_proj.weight"),
                    "down": t(f"{p}.mlp.down_proj.weight")},
            "ln1": vec(f"{p}.input_layernorm.weight"),
            "ln2": vec(f"{p}.post_attention_layernorm.weight"),
        })
    return {"embed": vec("embed_tokens.weight"), "layers": layers, "norm": vec("norm.weight"),
            "lm_head": t("lm_head.weight")}


def init_lora(cfg: MistralConfig, r: int = 8, alpha: int = 16, seed: int = 0, device="cuda",
              dtype=torch.float32) -> dict:
    """PEFT-style LoRA for q/k/v/o/gate/up/down per layer and the lm_head:
    ``a`` ~ N(0, 0.02), ``b`` = 0; ``r`` and ``alpha`` are 0-d fp32 leaves
    (the JAX tree's, which ``best.pth`` carries), frozen by the optimizer."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    dims = {"wq": (D, D), "wk": (D, kvd), "wv": (D, kvd), "wo": (D, D),
            "gate": (D, I), "up": (D, I), "down": (I, D)}

    def pair(din, dout):
        return {"a": (torch.randn(din, r, generator=g, device=dev) * 0.02).to(dtype),
                "b": torch.zeros(r, dout, dtype=dtype, device=dev)}

    layers = [{n: pair(*dims[n]) for n in dims} for _ in range(cfg.n_layers)]
    return {"layers": layers, "lm_head": pair(D, cfg.vocab_size),
            "r": torch.tensor(float(r), device=dev), "alpha": torch.tensor(float(alpha), device=dev)}


def lora_trainable_mask(lora: dict) -> dict:
    """True for the a/b tensors, False for the scalar ``r`` and ``alpha``."""
    def mark(t):
        if isinstance(t, dict):
            return {k: mark(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [mark(v) for v in t]
        return True

    return {**mark(lora), "r": False, "alpha": False}
