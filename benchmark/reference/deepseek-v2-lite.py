"""Plain reference of the ``deepseek-v2-lite`` configuration: the
multilingual captioner's mapper and language tag before DeepSeek-V2-Lite
(multi-head latent attention, DeepSeekMoE), served in bf16.

float32 with TF32 off, one layer's weights widened at a time, a full causal
forward over the whole sequence: MLA decompressed (keys and values per head
from ``kv_b``, no cache), every routed expert run in a loop over the rows
routed to it. It follows the DeepSeek-V2 paper (arXiv:2405.04434, sections
2.1-2.2) and the published ``modeling_deepseek.py``:

- RMSNorm (eps 1e-6) before attention and before the FFN, and on the
  latent ``c`` with its own scale;
- ``q = W_q x`` [H, dn + dr]; ``[c | k_pe] = W_kva x``; ``[k_nope_h | v_h]
  = W_kvb,h RMSNorm(c)``; RoPE on ``q_pe`` and the one shared ``k_pe``, its
  dims reordered from pairs to halves before ``rotate_half``, with YaRN's
  frequencies (factor 40 over 4,096, ramp between dims 10 and 23) and its
  score scale ``192^-0.5 (0.1 * 0.707 ln 40 + 1)^2``;
- layer 0 a dense SwiGLU; the others: softmax over 64 experts in float32,
  the top 6 probabilities as weights (not renormalised, times
  ``routed_scaling_factor``), plus the shared experts' SwiGLU;
- a final RMSNorm and an untied ``lm_head``.

Departures from the published code: every product is in float32 (the
published model computes in bf16, with the scores' softmax in float32);
the weights are random from the seed, and the RMSNorm scales are stored in
float32; the routed experts' gate and up weights are stored as one
``gateup`` [E, D, 2I] and ``down`` [E, I, D] (the transposes of stacked
``[E, out, in]`` matrices, the program's layout), which changes no value.

``bits=8`` is this reference (the configuration states bf16, so there is no
integer quantization to state). ``bits=4`` is the control of the caption
cell's check, "fp8 where it states bf16": both inputs of every product
rounded to float8 e4m3 with a per-tensor scale. ``act_dtype`` (a witness)
rounds the residual stream and every product's input and output to that
dtype. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import seeded_leaves, strict_fp32, sub_seed

BASE_STREAM, HEAD_STREAM = 1, 2


def _dims(cfg):
    H = cfg["num_attention_heads"]
    return dict(D=cfg["hidden_size"], V=cfg["vocab_size"], L=cfg["num_hidden_layers"], H=H,
                dn=cfg["qk_nope_head_dim"], dr=cfg["qk_rope_head_dim"], dv=cfg["v_head_dim"],
                r=cfg["kv_lora_rank"], E=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], I=cfg["moe_intermediate_size"],
                Is=cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
                Id=cfg["intermediate_size"])


def is_moe(cfg, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def make_caption_weights(cfg, seed: int, device) -> dict:
    """The captioner's weights from ``seed``, in two draws on ``device``:
    the decoder in bf16, the dtype it is stored and served in (matrices and
    embeddings N(0, 0.02), the router too), and in float32 the RMSNorm
    scales (1 + N(0, 0.1)) and the mapper (N(0, 0.02), biases too).

    ``{"mapper": [{"w" [in, out], "b"}], "embed" [V, D], "layers": [{"attn":
    {"wq", "wkva", "kv_norm", "wkvb", "wo"}, "mlp": {"gate", "up", "down"}
    (dense layers) or "moe": {"router" [D, E], "experts": {"gateup" [E, D,
    2I], "down" [E, I, D]}, "shared": {"gate", "up", "down"}}, "ln1",
    "ln2"}], "norm", "lm_head" [D, V]}``, weights [in, out]; the experts'
    are views of contiguous [E, out, in] buffers."""
    d = _dims(cfg)
    D, V, H, E, I = d["D"], d["V"], d["H"], d["E"], d["I"]
    base = [("embed", (V, D), 0.0, 0.02)]
    head = []
    for i in range(d["L"]):
        base += [(f"{i}.wq", (D, H * (d["dn"] + d["dr"])), 0.0, 0.02),
                 (f"{i}.wkva", (D, d["r"] + d["dr"]), 0.0, 0.02),
                 (f"{i}.wkvb", (d["r"], H * (d["dn"] + d["dv"])), 0.0, 0.02),
                 (f"{i}.wo", (H * d["dv"], D), 0.0, 0.02)]
        if is_moe(cfg, i):
            base += [(f"{i}.router", (D, E), 0.0, 0.02),
                     (f"{i}.gateup", (E, 2 * I, D), 0.0, 0.02),
                     (f"{i}.edown", (E, D, I), 0.0, 0.02)]
            ffn = d["Is"]
        else:
            ffn = d["Id"]
        base += [(f"{i}.gate", (D, ffn), 0.0, 0.02), (f"{i}.up", (D, ffn), 0.0, 0.02),
                 (f"{i}.down", (ffn, D), 0.0, 0.02)]
        head += [(f"{i}.ln1", (D,), 1.0, 0.1), (f"{i}.ln2", (D,), 1.0, 0.1),
                 (f"{i}.kv_norm", (d["r"],), 1.0, 0.1)]
    base += [("lm_head", (D, V), 0.0, 0.02)]
    b = seeded_leaves(base, sub_seed(seed, BASE_STREAM), device, torch.bfloat16)
    head += [("norm", (D,), 1.0, 0.1)]
    sizes = cfg["mapper"]["sizes"]
    for i, (a_in, a_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        head += [(f"mapper.{i}.w", (a_in, a_out), 0.0, 0.02), (f"mapper.{i}.b", (a_out,), 0.0, 0.02)]
    h = seeded_leaves(head, sub_seed(seed, HEAD_STREAM), device)
    layers = []
    for i in range(d["L"]):
        lp = {"attn": {"wq": b[f"{i}.wq"], "wkva": b[f"{i}.wkva"], "kv_norm": h[f"{i}.kv_norm"],
                       "wkvb": b[f"{i}.wkvb"], "wo": b[f"{i}.wo"]},
              "ln1": h[f"{i}.ln1"], "ln2": h[f"{i}.ln2"]}
        ffn = {n: b[f"{i}.{n}"] for n in ("gate", "up", "down")}
        if is_moe(cfg, i):
            lp["moe"] = {"router": b[f"{i}.router"],
                         "experts": {"gateup": b[f"{i}.gateup"].transpose(1, 2),
                                     "down": b[f"{i}.edown"].transpose(1, 2)},
                         "shared": ffn}
        else:
            lp["mlp"] = ffn
        layers.append(lp)
    return {"mapper": [{"w": h[f"mapper.{i}.w"], "b": h[f"mapper.{i}.b"]}
                       for i in range(len(sizes) - 1)],
            "embed": b["embed"], "layers": layers, "norm": h["norm"], "lm_head": b["lm_head"]}


def _fp8(t):
    """Round to float8 e4m3 with a per-tensor scale (amax -> 448)."""
    s = torch.clamp_min(t.abs().amax(), 1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def _yarn_inv_freq(cfg):
    """YaRN's inverse frequencies in float32, as the published
    ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    dim, base, rs = cfg["qk_rope_head_dim"], cfg["rope_theta"], cfg["rope_scaling"]
    ar = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** ar)
    inter = 1.0 / (rs["factor"] * base ** ar)

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / \
            (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def _mscale(scale, m):
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def softmax_scale(cfg) -> float:
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope_tables(cfg, T, device):
    rs = cfg["rope_scaling"]
    freqs = torch.outer(torch.arange(T, dtype=torch.float32), _yarn_inv_freq(cfg))
    emb = torch.cat([freqs, freqs], -1)
    m = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def _rope(x, cos, sin):
    """The published ``apply_rotary_pos_emb``: dims from pairs to halves,
    then ``rotate_half``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def mapper_prefix(weights, cfg, prefixes):
    h = prefixes.float()
    layers = weights["mapper"]
    for i, p in enumerate(layers):
        h = h @ p["w"] + p["b"]
        if i < len(layers) - 1:
            h = torch.tanh(h)
    return h.reshape(h.shape[0], cfg["mapper"]["prefix_length"], cfg["hidden_size"])


def _rounder(act_dtype):
    return (lambda t: t) if act_dtype is None else (lambda t: t.to(act_dtype).float())


def _product(bits: int, act_dtype):
    """``mm(a, b)``: a float32 product, its inputs and output rounded to
    ``act_dtype`` (if given), its inputs to fp8 at ``bits=4``."""
    rnd = _rounder(act_dtype)

    def mm(a, b):
        a, b = rnd(a), b.float()
        if bits == 4:
            a, b = _fp8(a), _fp8(b)
        return rnd(a @ b)

    return mm


@torch.no_grad()
def forward_hidden(weights, cfg, x, bits: int = 8, act_dtype=None):
    """The decoder stack over embeddings ``x`` [S, T, D] (float32) -> the
    final hidden states [S, T, D], before the last norm."""
    strict_fp32()
    rnd, mm = _rounder(act_dtype), _product(bits, act_dtype)
    d, eps = _dims(cfg), cfg["rms_norm_eps"]
    S, T, _ = x.shape
    H, dn, dr, dv, r = d["H"], d["dn"], d["dr"], d["dv"], d["r"]
    cos, sin = _rope_tables(cfg, T, x.device)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    scale = softmax_scale(cfg)

    def swiglu(p, h):
        return mm(torch.nn.functional.silu(mm(h, p["gate"])) * mm(h, p["up"]), p["down"])

    x = rnd(x)
    for i, p in enumerate(weights["layers"]):
        a = p["attn"]
        h = _rms(x, p["ln1"], eps)
        q = mm(h, a["wq"]).reshape(S, T, H, dn + dr).transpose(1, 2)
        kva = mm(h, a["wkva"])
        c = _rms(kva[..., :r], a["kv_norm"], eps)
        k_pe = _rope(kva[..., r:][:, None], cos, sin)                     # [S, 1, T, dr]
        kv = mm(c, a["wkvb"]).reshape(S, T, H, dn + dv).transpose(1, 2)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], -1)
        k = torch.cat([kv[..., :dn], k_pe.expand(S, H, T, dr)], -1)
        s = mm(q, k.transpose(-1, -2)) * scale
        prob = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
        o = mm(prob, kv[..., dn:]).transpose(1, 2).reshape(S, T, H * dv)
        x = rnd(x + mm(o, a["wo"]))
        h = _rms(x, p["ln2"], eps)
        if "moe" not in p:
            x = rnd(x + swiglu(p["mlp"], h))
            continue
        m = p["moe"]
        flat = h.reshape(-1, h.shape[-1])
        scores = torch.softmax(mm(flat, m["router"]), -1)
        w, idx = torch.topk(scores, d["k"], -1)
        w = w * cfg["routed_scaling_factor"]
        y = torch.zeros_like(flat)
        for e in range(d["E"]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            gu = mm(flat[rows], m["experts"]["gateup"][e])
            g, u = gu[:, :d["I"]], gu[:, d["I"]:]
            out = mm(torch.nn.functional.silu(g) * u, m["experts"]["down"][e])
            y.index_add_(0, rows, out * w[rows, slot][:, None])
        x = rnd(x + rnd(y.reshape(h.shape)) + swiglu(m["shared"], h))
    return x


@torch.no_grad()
def caption_logits(weights, cfg, prefixes, tokens, bits: int = 8, act_dtype=None):
    """Teacher-forced logits of greedy captions: the prompt is [mapper
    prefix | the language tag's tokens], then the served tokens. ``tokens``
    [S, N]; returns fp32 logits [S, N, vocab], row ``i`` the distribution
    the decode chose token ``i`` from. ``bits`` and ``act_dtype``: the
    module docstring."""
    strict_fp32()
    S, N = tokens.shape
    dev = prefixes.device
    tags = torch.tensor(cfg["serving"]["tag_ids"], device=dev)[None].expand(S, -1)
    emb = weights["embed"]
    x = torch.cat([mapper_prefix(weights, cfg, prefixes),
                   emb[tags].float(), emb[tokens[:, :N - 1]].float()], 1)
    Lp = x.shape[1] - (N - 1)
    x = forward_hidden(weights, cfg, x, bits, act_dtype)
    x = _rms(x[:, Lp - 1:], weights["norm"], cfg["rms_norm_eps"])
    return _product(bits, act_dtype)(x, weights["lm_head"])
