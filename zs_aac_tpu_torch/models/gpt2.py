"""GPT-2 language model, KV-cached, in PyTorch.

The counterpart of the JAX package's ``models/gpt2.py``: pure functions over
a parameter dictionary (HF ``Conv1D`` layout, weights ``[in, out]``), a
preallocated cache, and int8 serving (w8 / w8a8 weights, int8 KV cache).
Parameters are a dict of tensors shaped like the JAX pytree, with ``"h"`` a
list of per-layer dicts.

Departures from the JAX functions, all exact:

- the caches are updated in place (the JAX versions return new arrays);
- decode steps attend over the valid rows ``0..index`` only: the reference
  masks the rest to -1e9, which gives them an exact 0 weight;
- the int8 copy of ``wte`` is padded to a multiple of 8 rows (zero rows,
  scale 1) because ``torch._int_mm`` on CUDA wants N % 8 == 0; the logits
  are sliced back to the vocabulary.

The int8 GEMMs use ``torch._int_mm`` (int32 accumulation), as the JAX
package leaves them to XLA's ``dot_general``. The attention of the int8
decode step is kernel K1 (``ops/decode_attn.py``).

Beam search keeps one cache row per logical beam (``expand_beam_cache``,
``reorder_beam_cache``) and steps with ``gpt2_step``/``gpt2_step_q8`` at
B * K rows, where the JAX package's beam steps read an ancestry table.

Tensor parallelism (Megatron's, float path only, as the JAX package's
``shard_gpt2_params``): ``gpt2_embed``, ``gpt2_forward``, ``init_kv_cache``,
``gpt2_prefill`` and ``gpt2_step`` take ``tp``, the ``model`` axis of a mesh
(``parallel.mesh.Axis``), with ``params`` this rank's shard
(``parallel.tp.shard_gpt2_params``): f (``tp_copy``) before each
column-parallel product (``c_attn`` by heads, ``c_fc``), g (``tp_reduce``)
after each row-parallel one (both ``c_proj``) with its bias added after g,
a vocab-parallel embedding (out-of-shard ids masked, then g), and the
vocab-parallel logits gathered whole (``tp_gather``) before anything reads
them. The KV cache holds this rank's heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.ops.decode_attn import bf16_softmax, decode_attn_q8
from zs_aac_tpu_torch.ops.quant import div, int8_rescale, quant_act, quantize_vec
from zs_aac_tpu_torch.parallel.mesh import tp_copy, tp_gather, tp_reduce
from zs_aac_tpu_torch.parallel.tp import embed_lookup
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = [
    "GPT2Config",
    "convert_gpt2",
    "init_gpt2",
    "gpt2_embed",
    "gpt2_forward",
    "init_kv_cache",
    "gpt2_prefill",
    "gpt2_step",
    "gpt2_probe_step",
    "gpt2_probe_step_q8",
    "gpt2_commit_probe",
    "gpt2_commit_probe_q8",
    "quantize_gpt2_int8",
    "init_kv_cache_q8",
    "quantize_kv_cache",
    "gpt2_prefill_q8",
    "gpt2_step_q8",
    "expand_beam_cache",
    "reorder_beam_cache",
]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5


def _gelu_new(x):
    c = math.sqrt(2.0 / math.pi)
    with annotate("layer.act"):
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))


def _ln(x, p, eps):
    """LayerNorm with fp32 statistics; output in the input dtype."""
    with annotate("layer.norm"):
        xf = x.float()
        xc = xf - xf.mean(dim=-1, keepdim=True)
        var = xc.square().mean(dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)


def _int_mm(a, b):
    """int8 [M, K] x int8 [K, N] -> int32 [M, N]. On CUDA ``torch._int_mm``
    refuses M <= 16, so small batches are padded with zero rows."""
    M = a.shape[0]
    if a.is_cuda and (M <= 16 or M % 8):
        Mp = max(32, -(-M // 8) * 8)
        return torch._int_mm(F.pad(a, (0, 0, 0, Mp - M)), b)[:M]
    return torch._int_mm(a, b)


def _int8_dot(x, w, w_scale, out_dtype, w_contract_dim=0, bias=None):
    """W8A8: per-row int8 activations, an int8 x int8 GEMM with int32
    accumulation, the fp32 rescale, then the activation dtype, then
    ``bias`` if given (``ops/quant.py``: spans ``layer.quant`` and
    ``layer.rescale``, one kernel each on a card)."""
    xq, sx = quant_act(x)
    b = w if w_contract_dim == 0 else w.t()
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), b).reshape(*xq.shape[:-1], -1)
    return int8_rescale(y, sx, w_scale, out_dtype, bias)


def _mm(x, p):
    """x @ w + b for the float, w8 ({"w" int8, "scale"}) and w8a8
    ({"w" int8, "scale_a8"}) layouts; the bias add is span ``layer.rescale``."""
    w = p["w"]
    if "scale_a8" in p:
        return _int8_dot(x, w, p["scale_a8"], x.dtype, bias=p["b"])
    if w.dtype == torch.int8:
        y = (x @ w.to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = x @ w
    with annotate("layer.rescale"):
        return y + p["b"]


def _row(x, p, tp):
    """A row-parallel product: ``_mm`` in one process; under ``tp`` the
    partial product summed over the group (g), then the whole bias."""
    if tp is None:
        return _mm(x, p)
    return tp_reduce(x @ p["w"], tp) + p["b"]


def _heads(cfg: GPT2Config, tp) -> int:
    """The attention heads this rank holds."""
    return cfg.n_head // (tp.size if tp is not None else 1)


def _logits(x, params, cfg=None, tp=None):
    """Final logits ``x @ wte.T``; reads the int8 copy when present. Under
    ``tp``: this rank's vocabulary rows, gathered whole and cut to
    ``cfg.vocab_size`` (the shard pads the vocabulary to the group)."""
    V = params["wte"].shape[0]
    if tp is not None:
        return tp_gather(tp_copy(x, tp) @ params["wte"].t(), tp)[..., :cfg.vocab_size]
    if "wte_q" in params:
        q = params["wte_q"]
        if "scale_a8" in q:
            y = _int8_dot(x, q["w"], q["scale_a8"], x.dtype, w_contract_dim=1)
        else:
            y = (x @ q["w"].t().to(x.dtype)) * q["scale"].to(x.dtype)
        return y[..., :V]
    return x @ params["wte"].t()


def _split_heads(x, n_head):
    B, L, D = x.shape
    return x.reshape(B, L, n_head, D // n_head).transpose(1, 2)


def _merge_heads(x):
    B, H, L, d = x.shape
    return x.transpose(1, 2).reshape(B, L, H * d)


def _attn_block(p, cfg, x, *, bias, tp=None):
    C = cfg.n_embd
    H = _heads(cfg, tp)
    q, k, v = _mm(tp_copy(x, tp), p["c_attn"]).split(H * (C // cfg.n_head), dim=-1)
    q, k, v = (_split_heads(t, H) for t in (q, k, v))
    att = div(q @ k.transpose(-1, -2), math.sqrt(C // cfg.n_head))
    att = torch.softmax((att + bias).float(), dim=-1).to(x.dtype)
    out = _row(_merge_heads(att @ v), p["c_proj"], tp)
    return out, (k, v)


def _mlp_residual(blk, cfg, x, tp=None):
    h = _gelu_new(_mm(tp_copy(_ln(x, blk["ln_2"], cfg.layer_norm_epsilon), tp),
                      blk["mlp"]["c_fc"]))
    return x + _row(h, blk["mlp"]["c_proj"], tp)


def _block(p, cfg, x, *, bias, tp=None):
    a, kv = _attn_block(p["attn"], cfg, _ln(x, p["ln_1"], cfg.layer_norm_epsilon), bias=bias,
                        tp=tp)
    return _mlp_residual(p, cfg, x + a, tp), kv


def gpt2_embed(params, tokens, tp=None):
    """Token ids -> wte embeddings (vocabulary-parallel under ``tp``)."""
    return embed_lookup(params["wte"], tokens, tp)


def _causal_bias(L, dtype, device):
    causal = torch.ones(L, L, dtype=torch.bool, device=device).tril()
    return torch.where(causal, 0.0, -1e9).to(dtype)[None, None]


def gpt2_forward(params, cfg: GPT2Config, inputs_embeds,
                 attention_mask: Optional[torch.Tensor] = None, tp=None):
    """Full-sequence forward -> logits [B, L, vocab]; ``attention_mask``
    [B, L] is 1 where a position is kept; ``tp`` as in the module
    docstring."""
    B, L, D = inputs_embeds.shape
    dev = inputs_embeds.device
    x = inputs_embeds + params["wpe"][:L][None]
    bias = _causal_bias(L, torch.float32, dev)
    if attention_mask is not None:
        bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
    bias = bias.to(x.dtype)
    for blk in params["h"]:
        x, _ = _block(blk, cfg, x, bias=bias, tp=tp)
    x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
    return _logits(x, params, cfg, tp)


# ---------------------------------------------------------------------------
# KV-cached decoding
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  dtype=torch.float32, device="cuda", tp=None):
    """Preallocated cache: k/v stacked over layers, [n_layer, B, H, T, d]
    (H this rank's heads under ``tp``)."""
    d = cfg.n_embd // cfg.n_head
    shape = (cfg.n_layer, batch, _heads(cfg, tp), max_len, d)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def gpt2_prefill(params, cfg: GPT2Config, inputs_embeds, cache, return_hidden=False, tp=None):
    """Run the prompt, filling ``cache[:, :, :, :L]`` (rows past L are
    zeroed) in place. Returns (logits [B, L, vocab], cache), plus the
    post-``ln_f`` hidden states [B, L, D] when ``return_hidden`` (MAGIC's
    degeneration penalty reads them)."""
    B, L, D = inputs_embeds.shape
    x = inputs_embeds + params["wpe"][:L][None]
    bias = _causal_bias(L, x.dtype, x.device)
    for i, blk in enumerate(params["h"]):
        x, (k, v) = _block(blk, cfg, x, bias=bias, tp=tp)
        for name, t in (("k", k), ("v", v)):
            cache[name][i, :, :, :L] = t
            cache[name][i, :, :, L:] = 0
    x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
    if return_hidden:
        return _logits(x, params, cfg, tp), cache, x
    return _logits(x, params, cfg, tp), cache


def gpt2_step(params, cfg: GPT2Config, x_embed, cache, index: int, return_hidden=False,
              tp=None, softmax_dtype=torch.float32):
    """One cached decode step for the token at position ``index``.

    ``x_embed``: [B, D]. Writes the token's k/v into the cache in place and
    returns (logits [B, vocab] fp32, cache), plus the post-``ln_f`` hidden
    state [B, D] when ``return_hidden``. ``softmax_dtype=torch.bfloat16`` is
    the beam search's opt-in bf16 attention softmax (the JAX
    ``gpt2_step_beam`` branch, its query scaled by 1 / sqrt(d) before the
    product as there; ``ops.decode_attn.bf16_softmax``)."""
    x = (x_embed + params["wpe"][index])[:, None]
    d = cfg.n_embd // cfg.n_head
    H = _heads(cfg, tp)
    n = index + 1
    for i, blk in enumerate(params["h"]):
        h = _ln(x, blk["ln_1"], cfg.layer_norm_epsilon)
        q, k, v = _mm(tp_copy(h, tp), blk["attn"]["c_attn"]).split(H * d, dim=-1)
        q, k, v = (_split_heads(t, H) for t in (q, k, v))  # [B,H,1,d]
        with annotate("layer.attn"):
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, :, index] = k[:, :, 0]
            cv[:, :, index] = v[:, :, 0]
            keys = ck[:, :, :n].to(x.dtype).transpose(-1, -2)
            if softmax_dtype == torch.float32:
                att = torch.softmax(div(q @ keys, math.sqrt(d)).float(), dim=-1).to(x.dtype)
            elif softmax_dtype == torch.bfloat16:
                att = bf16_softmax((q * float(1.0 / math.sqrt(d))) @ keys, x.dtype)
            else:
                raise TypeError(f"gpt2_step: unsupported softmax dtype {softmax_dtype}")
            o = att @ cv[:, :, :n].to(x.dtype)
        x = x + _row(_merge_heads(o), blk["attn"]["c_proj"], tp)
        x = _mlp_residual(blk, cfg, x, tp)
    with annotate("decode.logits"):
        x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
        logits = _logits(x, params, cfg, tp)[:, 0].float()
    if return_hidden:
        return logits, cache, x[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# Probe steps (MAGIC): W candidate tokens per cache row
# ---------------------------------------------------------------------------


def _probe(params, cfg: GPT2Config, x_embed, cache, index: int, history):
    """The probe step over any cache layout. ``history(i, q)`` -> (the
    scores of ``q`` [B, H, W, d] against layer ``i``'s rows ``0..index-1``
    [B, H, W, index], a function of the softmax weights of those rows giving
    their value sum [B, H, W, d])."""
    B, W, D = x_embed.shape
    H = cfg.n_head
    d = D // H
    x = (x_embed + params["wpe"][index]).reshape(B * W, 1, D)
    ks_new, vs_new = [], []
    for i, blk in enumerate(params["h"]):
        h = _ln(x, blk["ln_1"], cfg.layer_norm_epsilon)
        q, k, v = (t.reshape(B, W, H, d).transpose(1, 2)            # [B, H, W, d]
                   for t in _mm(h, blk["attn"]["c_attn"]).split(D, dim=-1))
        ks_new.append(k)
        vs_new.append(v)
        s_hist, value_sum = history(i, q)
        s_own = (q[..., None, :] @ k[..., :, None])[..., 0]         # own token at index
        s = torch.cat([s_hist.float(), s_own.float()], dim=-1)
        att = torch.softmax(div(s, math.sqrt(d)), dim=-1).to(x.dtype)
        o = value_sum(att[..., :index]) + att[..., index:] * v
        x = x + _mm(o.transpose(1, 2).reshape(B * W, 1, D), blk["attn"]["c_proj"])
        x = _mlp_residual(blk, cfg, x)
    x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
    logits = _logits(x, params)[:, 0].float().reshape(B, W, -1)
    k_new = torch.stack(ks_new).transpose(2, 3)                      # [L, B, W, H, d]
    v_new = torch.stack(vs_new).transpose(2, 3)
    return logits, (k_new, v_new), x.reshape(B, W, D)


def gpt2_probe_step(params, cfg: GPT2Config, x_embed, cache, index: int):
    """Probe ``W`` candidate tokens per cache row without copying the cache
    (the JAX ``gpt2_probe_step``): the W queries of a row attend over the
    row's cached positions ``0..index-1`` plus each candidate's own k/v at
    ``index``; nothing is written. The JAX version masks positions from
    ``index`` on to -1e9 (an exact 0 weight); here they are not read.

    ``x_embed``: [B, W, D]; ``cache`` leaves [n_layer, B, H, T, d]. Returns
    (logits [B, W, V] fp32, (k_new, v_new) each [n_layer, B, W, H, d],
    hidden [B, W, D] after ``ln_f``); ``gpt2_commit_probe`` writes a chosen
    candidate's k/v."""
    dt = x_embed.dtype

    def history(i, q):
        kc = cache["k"][i][:, :, :index].to(dt)
        vc = cache["v"][i][:, :, :index].to(dt)
        return q @ kc.transpose(-1, -2), lambda att: att @ vc

    return _probe(params, cfg, x_embed, cache, index, history)


def gpt2_probe_step_q8(params, cfg: GPT2Config, x_embed, cache, index: int):
    """``gpt2_probe_step`` over the int8 KV cache and its scales (the JAX
    ``gpt2_probe_step_q8``): the history's scores are ``q . k8 * k_scale``
    and its value sum ``(p * v_scale) . v8``, in the activation dtype; the
    candidates' own k/v stay in full precision."""
    dt = x_embed.dtype

    def history(i, q):
        kc = cache["k"][i][:, :, :index].to(dt)
        vc = cache["v"][i][:, :, :index].to(dt)
        sk = cache["k_scale"][i][:, :, None, :index].to(dt)
        sv = cache["v_scale"][i][:, :, None, :index].to(dt)
        return (q @ kc.transpose(-1, -2)) * sk, lambda att: (att * sv) @ vc

    return _probe(params, cfg, x_embed, cache, index, history)


def _selected(new_kv, sel):
    """Each row's selected candidate k/v: [n_layer, B, H, d] each."""
    rows = torch.arange(sel.shape[0], device=sel.device)
    return tuple(t[:, rows, sel] for t in new_kv)


def gpt2_commit_probe(cache, new_kv, sel, index: int):
    """Write each row's selected candidate k/v (``sel`` [B], from
    ``gpt2_probe_step``) into the cache at ``index``, in place."""
    for name, t in zip(("k", "v"), _selected(new_kv, sel)):
        cache[name][:, :, :, index] = t
    return cache


def gpt2_commit_probe_q8(cache, new_kv, sel, index: int):
    """Quantize each row's selected candidate k/v (``quantize_vec``, the
    quantization kernel K1 commits) and write values and scales into the
    int8 cache at ``index``, in place."""
    for name, t in zip(("k", "v"), _selected(new_kv, sel)):
        q, scale = quantize_vec(t.float())
        cache[name][:, :, :, index] = q
        cache[name + "_scale"][:, :, :, index] = scale
    return cache


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _pad_wte_q(w, scale):
    """Pad the int8 lm-head to a multiple of 8 rows (zero rows, scale 1)."""
    pad = -w.shape[0] % 8
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
        scale = F.pad(scale, (0, pad), value=1.0)
    return w, scale


def quantize_gpt2_int8(params: dict, mode: str = "w8") -> dict:
    """Per-output-channel symmetric int8 weights for serving.

    ``"w8"`` dequantizes int8 weights into the activation dtype inside each
    matmul; ``"w8a8"`` also quantizes activations per row and runs int8
    GEMMs. ``wte`` stays float for the embedding lookup; ``wte_q`` is its
    per-row int8 copy for the logits (padded, see the module docstring)."""
    assert mode in ("w8", "w8a8"), mode
    skey = "scale" if mode == "w8" else "scale_a8"

    def qlin(p):
        w = p["w"].float()
        scale = div(torch.clamp_min(w.abs().amax(dim=0), 1e-8), 127.0)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"w": q, skey: scale, "b": p["b"]}

    h = [
        {
            "ln_1": blk["ln_1"],
            "ln_2": blk["ln_2"],
            "attn": {"c_attn": qlin(blk["attn"]["c_attn"]),
                     "c_proj": qlin(blk["attn"]["c_proj"])},
            "mlp": {"c_fc": qlin(blk["mlp"]["c_fc"]),
                    "c_proj": qlin(blk["mlp"]["c_proj"])},
        }
        for blk in params["h"]
    ]
    wte = params["wte"].float()
    wscale = div(torch.clamp_min(wte.abs().amax(dim=1), 1e-8), 127.0)
    wte_q = torch.clamp(torch.round(wte / wscale[:, None]), -127, 127).to(torch.int8)
    wte_q, wscale = _pad_wte_q(wte_q, wscale)
    return {
        "wte": params["wte"],
        "wte_q": {"w": wte_q, skey: wscale},
        "wpe": params["wpe"],
        "h": h,
        "ln_f": params["ln_f"],
    }


def convert_gpt2(state_dict, cfg: GPT2Config, device="cuda") -> dict:
    """HF ``GPT2LMHeadModel``/``GPT2Model`` state_dict (torch tensors or
    numpy arrays) -> parameter dict. ``Conv1D`` weights are already
    ``[in, out]``."""
    dev = resolve_device(device)
    sd = {k.removeprefix("transformer."): torch.as_tensor(v).to(dev)
          for k, v in state_dict.items()}

    def cv(prefix):
        return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}

    def ln(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    h = [
        {
            "ln_1": ln(f"h.{i}.ln_1"),
            "ln_2": ln(f"h.{i}.ln_2"),
            "attn": {"c_attn": cv(f"h.{i}.attn.c_attn"), "c_proj": cv(f"h.{i}.attn.c_proj")},
            "mlp": {"c_fc": cv(f"h.{i}.mlp.c_fc"), "c_proj": cv(f"h.{i}.mlp.c_proj")},
        }
        for i in range(cfg.n_layer)
    ]
    return {"wte": sd["wte.weight"], "wpe": sd["wpe.weight"], "h": h, "ln_f": ln("ln_f")}


def init_gpt2(cfg: GPT2Config, seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """Random init with GPT-2's scheme (normal 0.02, zero biases), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def nrm(*shape, std=0.02):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def lin(i, o):
        return {"w": nrm(i, o), "b": torch.zeros(o, dtype=dtype, device=dev)}

    def lnp(dim):
        return {"scale": torch.ones(dim, dtype=dtype, device=dev),
                "bias": torch.zeros(dim, dtype=dtype, device=dev)}

    D = cfg.n_embd
    h = [
        {
            "ln_1": lnp(D),
            "ln_2": lnp(D),
            "attn": {"c_attn": lin(D, 3 * D), "c_proj": lin(D, D)},
            "mlp": {"c_fc": lin(D, 4 * D), "c_proj": lin(4 * D, D)},
        }
        for _ in range(cfg.n_layer)
    ]
    return {"wte": nrm(cfg.vocab_size, D), "wpe": nrm(cfg.n_positions, D, std=0.01),
            "h": h, "ln_f": lnp(D)}


# ---------------------------------------------------------------------------
# int8-quantized KV cache (serving path)
# ---------------------------------------------------------------------------


def init_kv_cache_q8(cfg: GPT2Config, batch: int, max_len: int, device="cuda"):
    """Per-vector symmetric int8 KV cache: k/v [n_layer, B, H, T, d] int8,
    scales [n_layer, B, H, T] fp32. Layer ``i``'s slices are the
    head-structured [B, H, T, d] / [B, H, T] tensors kernel K1 takes."""
    d = cfg.n_embd // cfg.n_head
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, d)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=dev),
        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
    }


def quantize_kv_cache(full_cache) -> dict:
    """Quantize a float KV cache {"k", "v"} into the int8 + scales layout."""
    qk, sk = quantize_vec(full_cache["k"].float())
    qv, sv = quantize_vec(full_cache["v"].float())
    return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


def gpt2_prefill_q8(params, cfg: GPT2Config, inputs_embeds, cache):
    """Prefill, then quantize the prompt's K/V into the int8 cache in place.
    Rows past the prompt hold what the reference's quantized zero rows hold
    (value 0, scale 1e-8)."""
    B, L, _ = inputs_embeds.shape
    tmp = init_kv_cache(cfg, B, L, inputs_embeds.dtype, inputs_embeds.device)
    logits, full = gpt2_prefill(params, cfg, inputs_embeds, tmp)
    q = quantize_kv_cache(full)
    for name in ("k", "v", "k_scale", "v_scale"):
        cache[name][:, :, :, :L] = q[name]
        cache[name][:, :, :, L:] = 1e-8 if name.endswith("scale") else 0
    return logits, cache


def gpt2_step_q8(params, cfg: GPT2Config, x_embed, cache, index: int,
                 attention=decode_attn_q8, softmax_dtype=torch.float32):
    """One decode step over the int8 cache. Each layer's attention is one
    call of ``attention`` (kernel K1 by default; ``decode_attn_q8_plain``
    runs the plain version) with the softmax in ``softmax_dtype``, which
    also commits the token's quantized k/v row and scales at ``index``
    (span ``layer.attn``; the final norm and the LM head are span
    ``decode.logits``). Returns (logits [B, vocab] fp32, cache)."""
    B, C = x_embed.shape
    H = cfg.n_head
    x = (x_embed + params["wpe"][index])[:, None]
    for i, blk in enumerate(params["h"]):
        h = _ln(x, blk["ln_1"], cfg.layer_norm_epsilon)
        qkv = _mm(h, blk["attn"]["c_attn"])[:, 0]                 # [B, 3C]
        q, k, v = (t.view(B, H, C // H) for t in qkv.split(C, dim=-1))
        with annotate("layer.attn"):
            o = attention(q, k, v, cache["k"][i], cache["v"][i],
                          cache["k_scale"][i], cache["v_scale"][i], index, softmax_dtype)
        x = x + _mm(o.reshape(B, 1, C), blk["attn"]["c_proj"])
        x = _mlp_residual(blk, cfg, x)
    with annotate("decode.logits"):
        x = _ln(x, params["ln_f"], cfg.layer_norm_epsilon)
        return _logits(x, params)[:, 0].float(), cache


# ---------------------------------------------------------------------------
# Beam caches: one row per logical beam
# ---------------------------------------------------------------------------


def expand_beam_cache(cache, beam_size: int) -> dict:
    """A prefilled cache of B rows (either layout) -> B * beam_size rows,
    row ``b * beam_size + j`` a copy of row ``b``."""
    return {name: t.repeat_interleave(beam_size, dim=1) for name, t in cache.items()}


def reorder_beam_cache(cache, src, n_valid: int) -> dict:
    """After a beam step: row ``b * K + j`` takes row ``b * K + src[b, j]``
    over positions ``0..n_valid-1`` (k, v and, in the int8 layout, their
    scales), in place. ``src``: [B, K] source beams. Positions past
    ``n_valid`` are not read before the step that writes them."""
    B, K = src.shape
    rows = (torch.arange(B, device=src.device)[:, None] * K + src).reshape(-1)
    for t in cache.values():
        valid = t[:, :, :, :n_valid]
        valid.copy_(valid.index_select(1, rows))
    return cache
