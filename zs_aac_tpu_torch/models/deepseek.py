"""DeepSeek-V2 decoder (multi-head latent attention and DeepSeekMoE) over a
latent cache, in PyTorch.

No counterpart in the JAX package: this decoder serves the multilingual
captioner (``models/caption_mistral.py``) in place of Mistral. It follows
the DeepSeek-V2 paper (arXiv:2405.04434, sections 2.1 and 2.2) and the
published ``modeling_deepseek.py`` of ``deepseek-ai/DeepSeek-V2-Lite``, for
the configurations without query compression (``q_lora_rank`` null),
softmax scoring, greedy top-k and no renormalisation of the top-k weights.

Parameters are a dictionary shaped like ``models/mistral.py``'s (weights
``[in, out]``; ``"layers"`` a list of per-layer dicts):

- ``attn``: ``wq`` [D, H (dn + dr)], ``wkva`` [D, r + dr] (the latent, then
  the shared RoPE key), ``kv_norm`` [r], ``wkvb`` [r, H (dn + dv)], ``wo``
  [H dv, D];
- ``mlp`` (the leading dense layers): ``gate``, ``up``, ``down``;
- ``moe``: ``router`` [D, E]; ``experts``: ``gateup`` [E, D, 2I] (gate
  columns, then up) and ``down`` [E, I, D], each the transpose of a
  contiguous ``[E, out, in]``, which is how a checkpoint stacks them and
  how ``torch._grouped_mm`` takes them; ``shared``: ``gate``, ``up``,
  ``down`` (the shared experts as one SwiGLU);
- ``ln1``, ``ln2``; and ``embed`` [V, D], ``norm``, ``lm_head`` [D, V].

``prepare_deepseek_v2`` turns them into the serving form once: ``wq`` and
``wkva`` joined into one GEMM, ``W_UK`` and ``W_UV`` as [H, dn, r] and [H,
dv, r] views of ``wkvb``. RoPE turns each dimension pair (2j, 2j + 1) of
q_pe and k_pe at frequency j, as a complex product in float32: the
published code reorders the pairs to halves before ``rotate_half``, which
turns the same pairs and leaves every score the same. YaRN sets the
frequencies and the score scale.

The cache holds one latent row a position a layer, ``[n_layers, B, T, r +
dr]``: the normalised latent ``c`` and the roped key ``k_pe``, shared by
every head. The prefill runs MLA decompressed (keys and values per head
from ``wkvb``) and fills the cache; a step runs the absorbed form, which
reads the cache alone: ``q~_h = W_UK,h^T q_nope,h``, ``s_h(t) = scale (q~_h
. c(t) + q_pe,h . k_pe(t))``, ``o_h = W_UV,h sum_t p_h(t) c(t)``.

MoE: the router in float32 (softmax over the experts, the top k as the
weights), the rows sorted by expert with a stable sort, the per-expert
offsets searched in the sorted ids on the device, two
``torch._grouped_mm`` (gate and up together, then down), the rows put back
by the inverse permutation and summed over their k experts in float32 in
a fixed order, added to the shared experts' output with one rounding.
Nothing in a step or the prefill waits for the host (no ``.item()``,
``nonzero``, boolean indexing or ``bincount``), and no atomics sum the
combine: one batch gives the same tokens every time.

Spans (``utils/profiling.py``): ``layer.attn`` from the RoPE and the cache
commit to the output before ``wo``, in a step; ``layer.router`` (the gate
GEMM, softmax, top k, the sort, offsets, the permuting gather);
``layer.experts`` (both grouped GEMMs and the SwiGLU between);
``layer.combine`` (the inverse permutation, the weighted sum, the add to
the shared experts' output); the dense layer and the shared experts run
``models/mistral.py::_mlp`` with its own spans. ``MOE_COUNTERS`` counts
the most-loaded expert's rows on the device, routed rows, MoE layer calls
and grouped-GEMM launches on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.models.mistral import _base_matmul, _mlp, _rms_norm
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = [
    "DeepseekV2Config",
    "MOE_COUNTERS",
    "convert_deepseek_v2",
    "deepseek_embed",
    "deepseek_forward",
    "deepseek_prefill",
    "deepseek_step",
    "init_deepseek_cache",
    "prepare_deepseek_v2",
    "softmax_scale",
    "yarn_correction_range",
    "yarn_inv_freq",
]


def _yarn_default():
    return {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
            "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published ``config.json`` keys, under their own names. Defaults:
    ``deepseek-ai/DeepSeek-V2-Lite``."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = dataclasses.field(default_factory=_yarn_default)
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    norm_topk_prob: bool = False
    n_group: int = 1
    topk_group: int = 1
    max_position_embeddings: int = 163840

    def __post_init__(self):
        unsupported = {"q_lora_rank": (self.q_lora_rank, None),
                       "scoring_func": (self.scoring_func, "softmax"),
                       "topk_method": (self.topk_method, "greedy"),
                       "norm_topk_prob": (self.norm_topk_prob, False)}
        for key, (got, want) in unsupported.items():
            if got != want:
                raise ValueError(f"DeepseekV2Config: {key}={got!r} is not served (only {want!r})")
        if self.rope_scaling is not None and self.rope_scaling.get("type") != "yarn":
            raise ValueError(f"rope_scaling {self.rope_scaling!r} is not served: only yarn")

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """From a ``config.json``'s keys; the keys that name no field (the
        model type, the auxiliary loss, ...) are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def n_layers(self) -> int:
        return self.num_hidden_layers

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, i: int) -> bool:
        return i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0


# ---------------------------------------------------------------------------
# YaRN RoPE (the published DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config):
    """(low, high) dimension pair indices of YaRN's ramp: ``floor`` and
    ``ceil`` of the dimensions whose wavelength turns ``beta_fast`` and
    ``beta_slow`` times over the original context."""
    rs, dim = cfg.rope_scaling, cfg.qk_rope_head_dim

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / \
            (2 * math.log(cfg.rope_theta))

    return max(math.floor(corr(rs["beta_fast"])), 0), min(math.ceil(corr(rs["beta_slow"])),
                                                          dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> np.ndarray:
    """The inverse frequencies [dr / 2] in float32, as the published code
    computes them: the original frequencies below the ramp, those over
    ``factor`` above it, linear in between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    ar = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    extra = np.float32(1.0) / (np.float32(base) ** ar)
    if cfg.rope_scaling is None:
        return extra
    factor = np.float32(cfg.rope_scaling["factor"])
    inter = np.float32(1.0) / (factor * np.float32(base) ** ar)
    low, high = yarn_correction_range(cfg)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low) / np.float32(high - low), 0, 1)
    mask = np.float32(1.0) - ramp.astype(np.float32)
    return (inter * (np.float32(1.0) - mask) + extra * mask).astype(np.float32)


def _rope_mscale(cfg: DeepseekV2Config) -> float:
    rs = cfg.rope_scaling
    if rs is None:
        return 1.0
    return _yarn_mscale(rs["factor"], rs["mscale"]) / _yarn_mscale(rs["factor"],
                                                                  rs["mscale_all_dim"])


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``q_head_dim ** -0.5``, times ``mscale(factor, mscale_all_dim) ** 2``
    under YaRN (0.114721 for DeepSeek-V2-Lite)."""
    s = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.get("mscale_all_dim"):
        m = _yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        s = s * m * m
    return s


_INV_FREQ: dict = {}


def _inv_freq_on(cfg: DeepseekV2Config, device: torch.device) -> torch.Tensor:
    """The inverse frequencies on ``device``, copied from the host once per
    RoPE setting (a copy each step would wait for the device)."""
    rs = cfg.rope_scaling
    key = (cfg.qk_rope_head_dim, cfg.rope_theta,
           None if rs is None else tuple(sorted(rs.items())), device)
    if key not in _INV_FREQ:
        _INV_FREQ[key] = torch.from_numpy(yarn_inv_freq(cfg)).to(device)
    return _INV_FREQ[key]


def _rope_freqs(cfg: DeepseekV2Config, positions: torch.Tensor) -> torch.Tensor:
    """``m e^(i t f_j)`` [L, dr / 2] complex64: each position's rotation of
    dimension pair j, YaRN's cos/sin scale ``m`` as its modulus."""
    ang = positions[:, None].float() * _inv_freq_on(cfg, positions.device)[None, :]
    return torch.polar(torch.full_like(ang, _rope_mscale(cfg)), ang)


def _rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """RoPE on ``x`` [..., L, dr] -> float32: dimensions (2j, 2j + 1) turn
    together at frequency j, as the published code turns them (it reorders
    them to halves first; the scores are the same). The caller casts."""
    z = torch.view_as_complex(x.float().unflatten(-1, (-1, 2))) * freqs
    return torch.view_as_real(z).flatten(-2)


# ---------------------------------------------------------------------------
# Serving form
# ---------------------------------------------------------------------------


def prepare_deepseek_v2(params: dict, cfg: DeepseekV2Config) -> dict:
    """The serving form of ``params`` (module docstring): ``wq`` and
    ``wkva`` joined into ``wqkva`` [D, H (dn + dr) + r + dr] (one GEMM a
    step), ``w_uk`` [H, dn, r] and ``w_uv`` [H, dv, r] as views of ``wkvb``,
    the router in float32. Every other leaf is shared with ``params``."""
    H, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    layers = []
    for lp in params["layers"]:
        a = lp["attn"]
        kvb = a["wkvb"].t().unflatten(0, (H, dn + dv))          # [H, dn + dv, r], a view
        attn = {"wqkva": torch.cat([a["wq"], a["wkva"]], dim=1), "kv_norm": a["kv_norm"],
                "wkvb": a["wkvb"], "w_uk": kvb[:, :dn], "w_uv": kvb[:, dn:], "wo": a["wo"]}
        out = {"attn": attn, "ln1": lp["ln1"], "ln2": lp["ln2"]}
        if "moe" in lp:
            m = lp["moe"]
            out["moe"] = {"router": m["router"].float(), "experts": m["experts"],
                          "shared": m["shared"]}
        else:
            out["mlp"] = lp["mlp"]
        layers.append(out)
    return {"embed": params["embed"], "layers": layers, "norm": params["norm"],
            "lm_head": params["lm_head"]}


_ARANGE: dict = {}


def _arange(n: int, device) -> torch.Tensor:
    """``arange(n)`` on ``device`` (int64), made once."""
    key = (n, torch.device(device))
    if key not in _ARANGE:
        _ARANGE[key] = torch.arange(n, device=device)
    return _ARANGE[key]


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


class MoeCounters:
    """The MoE layers' counters: ``expert_rows_max_sum`` (the most-loaded
    expert's rows, summed over MoE layer calls) adds up on the device with
    no wait for it; ``routed_rows`` (k a row), ``layer_steps`` (MoE layer
    calls, the prefill's included) and ``grouped_mm_launches`` on the host.
    ``read()`` reads the device once."""

    def __init__(self):
        self.reset()

    def reset(self):
        if getattr(self, "_top", None) is not None:
            self._top.zero_()                # CUDA graphs hold this tensor: keep it
        else:
            self._top: Optional[torch.Tensor] = None
        self.set_host((0, 0, 0))

    def host(self) -> tuple:
        return self.routed_rows, self.layer_steps, self.grouped_mm_launches

    def set_host(self, counts: tuple):
        self.routed_rows, self.layer_steps, self.grouped_mm_launches = counts

    def replayed(self, layers: int, rows: int):
        """A replayed step's host counts: ``layers`` MoE layer calls of
        ``rows`` routed rows each (its device count is in the graph)."""
        self.routed_rows += layers * rows
        self.layer_steps += layers
        self.grouped_mm_launches += 2 * layers

    def add(self, counts: torch.Tensor, rows: int):
        """One MoE layer call: ``counts`` [E] its rows per expert (on the
        device), ``rows`` the rows it routed."""
        if self._top is None or self._top.device != counts.device:
            self._top = torch.zeros((), dtype=torch.int64, device=counts.device)
        self._top.add_(counts.amax())
        self.routed_rows += rows
        self.layer_steps += 1
        self.grouped_mm_launches += 2

    def read(self) -> dict:
        return {"moe.routed_rows": self.routed_rows,
                "moe.expert_rows_max_sum": 0 if self._top is None else int(self._top),
                "moe.layer_steps": self.layer_steps,
                "moe.grouped_mm.launches": self.grouped_mm_launches}


MOE_COUNTERS = MoeCounters()


def route(p, cfg: DeepseekV2Config, x):
    """The router of a MoE layer: ``x`` [N, D] -> (weights [N, k] fp32,
    expert ids [N, k]): softmax over the experts in float32, the top k,
    their probabilities times ``routed_scaling_factor``."""
    scores = torch.softmax(x.float() @ p["router"], dim=-1)
    w, idx = torch.topk(scores, cfg.num_experts_per_tok, dim=-1)
    if cfg.routed_scaling_factor != 1.0:
        w = w * cfg.routed_scaling_factor
    return w, idx


def _moe(p, cfg: DeepseekV2Config, x):
    """A MoE layer over ``x`` [..., D] (module docstring)."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    N, k, E = x.shape[0], cfg.num_experts_per_tok, cfg.n_routed_experts
    with annotate("layer.router"):
        w, idx = route(p, cfg, x)
        ids, order = torch.sort(idx.reshape(-1), stable=True)   # rows grouped by expert
        # group e's rows end where the sorted ids pass e: [0, offs_0, ..., offs_E-1]
        bounds = torch.searchsorted(ids, _arange(E + 1, x.device), out_int32=True)
        offs = bounds[1:]
        MOE_COUNTERS.add(offs - bounds[:-1], N * k)
        xs = x.index_select(0, order // k)
    ex = p["experts"]
    with annotate("layer.experts"):
        gu = torch._grouped_mm(xs, ex["gateup"], offs=offs)
        I = gu.shape[-1] // 2
        h = F.silu(gu[:, :I]) * gu[:, I:]
        ys = torch._grouped_mm(h, ex["down"], offs=offs)
    out = _mlp(p["shared"], x, None, None)
    with annotate("layer.combine"):
        inv = torch.empty_like(order).scatter_(0, order, _arange(N * k, x.device))
        y = ys.index_select(0, inv).view(N, k, -1).float()
        out.add_(torch.bmm(w[:, None], y)[:, 0])         # the k-sum in float32, one rounding
    return out.reshape(shape)


def _ffn(p, cfg, x):
    return _moe(p["moe"], cfg, x) if "moe" in p else _mlp(p["mlp"], x, None, None)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _latent(a, cfg: DeepseekV2Config, h):
    """``h`` [B, L, D] -> (q [B, L, H, dn + dr], c normalised [B, L, r],
    k_pe [B, L, dr], before RoPE)."""
    H, r = cfg.num_attention_heads, cfg.kv_lora_rank
    qkva = _base_matmul(h, a["wqkva"])
    nq = H * cfg.q_head_dim
    q = qkva[..., :nq].unflatten(-1, (H, cfg.q_head_dim))
    c = _rms_norm(qkva[..., nq:nq + r], a["kv_norm"], cfg.rms_norm_eps)
    return q, c, qkva[..., nq + r:]


def _mla_full(a, cfg: DeepseekV2Config, h, freqs, bias):
    """Decompressed MLA over a whole sequence -> (out [B, L, D], the cache
    rows [B, L, r + dr])."""
    B, L, _ = h.shape
    H, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q, c, k_pe = _latent(a, cfg, h)
    q = q.transpose(1, 2)                                               # [B, H, L, dn + dr]
    k_pe = _rope(k_pe, freqs).to(h.dtype)                               # [B, L, dr]
    kv = _base_matmul(c, a["wkvb"]).reshape(B, L, H, dn + dv).transpose(1, 2)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], freqs).to(h.dtype)], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe[:, None].expand(B, H, L, -1)], dim=-1)
    att = (q @ k.transpose(-1, -2)) * softmax_scale(cfg)
    att = torch.softmax((att + bias).float(), dim=-1).to(h.dtype)
    o = (att @ kv[..., dn:]).transpose(1, 2).reshape(B, L, H * dv)
    return _base_matmul(o, a["wo"]), torch.cat([c, k_pe], dim=-1)


def _causal_bias(L, dtype, device):
    pos = torch.arange(L, device=device)
    return torch.where(pos[None, :] <= pos[:, None], 0.0, -1e9).to(dtype)[None, None]


def deepseek_embed(params, tokens):
    return params["embed"][tokens]


def _decoder(params, cfg, x, on_latent=None):
    """The decoder stack over a full sequence -> final hidden states;
    ``on_latent(i, rows)`` receives each layer's cache rows."""
    L = x.shape[1]
    freqs = _rope_freqs(cfg, torch.arange(L, device=x.device))
    bias = _causal_bias(L, x.dtype, x.device)
    for i, p in enumerate(params["layers"]):
        h = _rms_norm(x, p["ln1"], cfg.rms_norm_eps)
        o, rows = _mla_full(p["attn"], cfg, h, freqs, bias)
        if on_latent is not None:
            on_latent(i, rows)
        x = x + o
        x = x + _ffn(p, cfg, _rms_norm(x, p["ln2"], cfg.rms_norm_eps))
    return x


def _head(params, cfg, x):
    return _base_matmul(_rms_norm(x, params["norm"], cfg.rms_norm_eps), params["lm_head"])


def deepseek_forward(params, cfg: DeepseekV2Config, inputs_embeds):
    """Causal forward over ``inputs_embeds`` [B, L, D] -> logits [B, L, V]
    (``params`` in the serving form)."""
    return _head(params, cfg, _decoder(params, cfg, inputs_embeds))


CACHE_ALIGN = 8   # positions: a step's score and value GEMMs take rows in 16-byte runs


def init_deepseek_cache(cfg: DeepseekV2Config, batch: int, max_len: int,
                        dtype=torch.bfloat16, device="cuda"):
    """The latent cache [n_layers, B, T, r + dr], ``T`` = ``max_len`` rounded
    up to a multiple of ``CACHE_ALIGN``: per position the normalised
    latent, then the roped shared key."""
    T = -(-max_len // CACHE_ALIGN) * CACHE_ALIGN
    return torch.zeros(cfg.num_hidden_layers, batch, T, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                       dtype=dtype, device=resolve_device(device))


def deepseek_prefill(params, cfg: DeepseekV2Config, inputs_embeds, cache):
    """Run the prompt, writing its latent rows into positions ``0..L-1`` of
    the cache in place. Returns (logits of the last position [B, V],
    cache): the head runs on that position alone."""
    L = inputs_embeds.shape[1]

    def on_latent(i, rows):
        cache[i, :, :L] = rows

    x = _decoder(params, cfg, inputs_embeds, on_latent)
    return _head(params, cfg, x[:, -1]), cache


def score_rows(index: int, max_len: int) -> int:
    """The cache rows a step at position ``index`` scores: ``index + 1``
    rounded up to ``CACHE_ALIGN``, at most ``max_len``."""
    return min(-(-(index + 1) // CACHE_ALIGN) * CACHE_ALIGN, max_len)


def deepseek_step(params, cfg: DeepseekV2Config, x_embed, cache, index, n=None):
    """One cached step for the token at position ``index`` (``x_embed`` [B,
    D]): absorbed MLA over the cache's rows ``0..index``, its own row
    written first. ``index`` is an int, or a [1] int64 tensor on the
    device with ``n`` (``score_rows``) given, so that one CUDA graph serves
    every position of a width. The scores run over ``n`` rows, those past
    ``index`` masked out. Returns (logits [B, V], cache). Spans:
    ``layer.attn`` from the RoPE and the commit to the output before
    ``wo``, ``decode.logits`` over the head."""
    B = x_embed.shape[0]
    H, dn, r, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank,
                    cfg.v_head_dim)
    dev = x_embed.device
    x = x_embed[:, None]
    if isinstance(index, int):
        index, n = torch.full((1,), index, device=dev), score_rows(index, cache.shape[2])
    freqs = _rope_freqs(cfg, index)
    mask = torch.where(_arange(n, dev) <= index, 0.0, -math.inf)        # float32 [n]
    scale = softmax_scale(cfg)
    for i, p in enumerate(params["layers"]):
        a = p["attn"]
        h = _rms_norm(x, p["ln1"], cfg.rms_norm_eps)
        q, c, k_pe = _latent(a, cfg, h)                                 # q [B, 1, H, dn + dr]
        q = q[:, 0]
        with annotate("layer.attn"):
            kv = cache[i]                                               # [B, T, r + dr]
            kv[..., :r].index_copy_(1, index, c)
            kv[..., r:].index_copy_(1, index, _rope(k_pe, freqs).to(x.dtype))
            qf = torch.empty(B, H, r + cfg.qk_rope_head_dim, dtype=x.dtype, device=dev)
            qf[..., :r] = torch.bmm(q[..., :dn].transpose(0, 1), a["w_uk"]).transpose(0, 1)
            qf[..., r:] = _rope(q[..., dn:], freqs)
            kv = kv[:, :n]
            s = torch.bmm(qf, kv.transpose(1, 2))                       # [B, H, n]
            prob = torch.softmax(torch.add(mask, s, alpha=scale), dim=-1).to(x.dtype)
            o_lat = torch.bmm(prob, kv[..., :r])                        # [B, H, r]
            o = torch.bmm(o_lat.transpose(0, 1), a["w_uv"].transpose(1, 2))   # [H, B, dv]
            o = o.transpose(0, 1).reshape(B, 1, H * dv)
        x = x + _base_matmul(o, a["wo"])
        x = x + _ffn(p, cfg, _rms_norm(x, p["ln2"], cfg.rms_norm_eps))
    with annotate("decode.logits"):
        return _head(params, cfg, x)[:, 0], cache


class StepGraphs:
    """The cached steps of one batch size over a latent cache that stays
    from batch to batch (rows past a step's position are masked, so a batch
    needs no fresh cache): on a card as CUDA graphs, one a score width
    ``n``; on the CPU, and on a card while a profiler records (so that the
    steps show their spans), eagerly, with the same kernels.

    On a card the first step at a width runs eagerly on a side stream, and
    its logits are that step's; it is then captured, and later steps at
    that width replay it: a step costs the host one replay instead of
    ~2,600 launches. ``step`` copies the tokens and the position into the
    graphs' buffers; the logits it returns are valid until the next step.
    The graphs share one memory pool (they run one at a time)."""

    def __init__(self, params, cfg: DeepseekV2Config, batch: int, max_len: int,
                 dtype=torch.bfloat16, device="cuda"):
        self.params, self.cfg = params, cfg
        dev = resolve_device(device)
        self.cache = init_deepseek_cache(cfg, batch, max_len, dtype, dev)
        self.tokens = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graphs: dict = {}
        self._pool = None
        self._moe = sum(cfg.is_moe(i) for i in range(cfg.num_hidden_layers))

    def _eager(self, n):
        x = deepseek_embed(self.params, self.tokens)
        return deepseek_step(self.params, self.cfg, x, self.cache, self.index, n)[0]

    def step(self, tokens: torch.Tensor, index: int) -> torch.Tensor:
        n = score_rows(index, self.cache.shape[2])
        self.tokens.copy_(tokens)
        self.index.fill_(index)
        if self.cache.device.type != "cuda" or torch.autograd.profiler._is_profiler_enabled:
            return self._eager(n)
        if n in self.graphs:
            graph, logits = self.graphs[n]
            graph.replay()
            MOE_COUNTERS.replayed(self._moe, tokens.shape[0] * self.cfg.num_experts_per_tok)
            return logits
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            logits = self._eager(n)          # this step's answer, and the capture's warm-up
        torch.cuda.current_stream().wait_stream(side)
        counted = MOE_COUNTERS.host()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = self._eager(n)
        MOE_COUNTERS.set_host(counted)       # a capture runs nothing
        self.graphs[n] = (graph, out)
        return logits


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def convert_deepseek_v2(state_dict, cfg: DeepseekV2Config, device="cuda",
                        dtype=torch.bfloat16) -> dict:
    """A published ``DeepseekV2ForCausalLM`` state dict (torch tensors or
    numpy arrays) -> the parameter dict (module docstring; not yet the
    serving form): linear weights transposed to [in, out], the routed
    experts stacked as ``[E, out, in]`` and taken transposed."""
    dev = resolve_device(device)
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}

    def get(name):
        v = sd[name]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        return v.to(device=dev, dtype=dtype)

    def t(name):
        return get(name).t().contiguous()

    def mlp(prefix):
        return {"gate": t(f"{prefix}.gate_proj.weight"), "up": t(f"{prefix}.up_proj.weight"),
                "down": t(f"{prefix}.down_proj.weight")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p, s = f"layers.{i}", f"layers.{i}.self_attn"
        out = {"attn": {"wq": t(f"{s}.q_proj.weight"),
                        "wkva": t(f"{s}.kv_a_proj_with_mqa.weight"),
                        "kv_norm": get(f"{s}.kv_a_layernorm.weight"),
                        "wkvb": t(f"{s}.kv_b_proj.weight"), "wo": t(f"{s}.o_proj.weight")},
               "ln1": get(f"{p}.input_layernorm.weight"),
               "ln2": get(f"{p}.post_attention_layernorm.weight")}
        if cfg.is_moe(i):
            ex = [f"{p}.mlp.experts.{e}" for e in range(cfg.n_routed_experts)]
            gateup = torch.stack([torch.cat([get(f"{e}.gate_proj.weight"),
                                             get(f"{e}.up_proj.weight")]) for e in ex])
            down = torch.stack([get(f"{e}.down_proj.weight") for e in ex])
            out["moe"] = {"router": t(f"{p}.mlp.gate.weight"),
                          "experts": {"gateup": gateup.transpose(1, 2),
                                      "down": down.transpose(1, 2)},
                          "shared": mlp(f"{p}.mlp.shared_experts")}
        else:
            out["mlp"] = mlp(f"{p}.mlp")
        layers.append(out)
    return {"embed": get("embed_tokens.weight"), "layers": layers, "norm": get("norm.weight"),
            "lm_head": t("lm_head.weight")}
