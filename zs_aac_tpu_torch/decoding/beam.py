"""Beam search over a KV cache.

The counterpart of the JAX package's ``decoding/beam.py`` (the reference's
``generate_beam``), with its scoring semantics:

- the first K tokens are the top K of ``log_softmax(logits / temperature)``;
- each step ranks the K x V candidates by ``(scores + logp) / new_len``, a
  stopped beam contributing one forced token 0 at log-probability 0 and
  keeping its length; then ``scores = top_avg * seq_lengths``;
- a beam stops on ``stop_token_id`` only (greedy also stops on 764);
- the final scores are ``scores / seq_lengths``.

All score arithmetic is fp32 whatever the model's dtype. Ties go to the
lower flat index, as the JAX ``top_k`` and its k argmax passes order them.

One cache row per logical beam, row ``b * K + j`` of the port's
``[n_layer, B * K, H, T, d]`` cache: the prompt is prefilled once at B rows
and repeated K times, each step is ``gpt2_step`` (``gpt2_step_q8``, whose
attention is kernel K1) at B * K rows, and after each selection
``reorder_beam_cache`` copies each beam's source row over the valid
positions. This replaces the JAX package's ancestry table, head-folded
cache and grouped lm head (TPU layout choices): each logical beam attends
over its own history there too, the other rows getting an exact 0 weight.
The loop runs on the host and leaves early once every beam has stopped,
checking every ``CHECK_EVERY`` steps; a step after that re-selects each
beam's token 0 in the same order, so the outputs do not change.
"""

from __future__ import annotations

import torch

from zs_aac_tpu_torch.decoding.greedy import CHECK_EVERY
from zs_aac_tpu_torch.models.gpt2 import (
    GPT2Config,
    expand_beam_cache,
    gpt2_embed,
    gpt2_prefill,
    gpt2_prefill_q8,
    gpt2_step,
    gpt2_step_q8,
    init_kv_cache,
    init_kv_cache_q8,
    reorder_beam_cache,
)
from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8

__all__ = ["beam_search", "beam_search_batched", "beam_search_batched_q8"]

_NEG_INF = -1e9
_DIRECT_MAX_VOCAB = 4096  # larger vocabularies take the affine ranking form


def _topk_argmax(x: torch.Tensor, k: int):
    """Top k over the last axis as k argmax passes: (values, indices).
    ``torch.argmax`` returns the first maximal index, so equal values come
    out lower index first (``torch.topk`` promises no order for ties)."""
    x = x.clone()
    vals, idxs = [], []
    for j in range(k):
        i = x.argmax(dim=-1, keepdim=True)
        vals.append(x.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        if j + 1 < k:
            x.scatter_(-1, i, -torch.inf)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def _beam_select(logits, scores, seq_lengths, is_stopped, temperature, B, K):
    """The K best (source beam, token) continuations per clip.

    ``logits`` [B*K, V] (any float dtype), ``scores``/``seq_lengths`` [B, K]
    fp32, ``is_stopped`` [B, K] bool. Returns (top_avg [B, K] fp32
    length-normalised, src [B, K] source beam, nxt [B, K] token, new_len
    [B, K] lengths before the gather).

    Up to 4096 tokens the averages are materialised from ``log_softmax`` as
    the reference does. Above, they are the JAX package's affine form
    ``A * logit + Bc`` with ``lse = rowmax / t + log sum exp((logit -
    rowmax) / t)``, ``A = 1 / (t new_len)`` and ``Bc = (scores - lse) /
    new_len``; a stopped row has ``A = 0``, ``Bc = (scores - 1e9) /
    new_len``, and its token 0 is overridden by ``scores / new_len``. The
    two forms round differently in fp32, so each keeps its own formula. The
    JAX package ranks the affine form in two stages over groups of the
    vocabulary (a TPU layout); here it is materialised over [B, K*V], the
    same values element by element."""
    V = logits.shape[-1]
    new_len = torch.where(is_stopped, seq_lengths, seq_lengths + 1)
    lg = logits.reshape(B, K, V).float()
    stopped = is_stopped[..., None]
    if V <= _DIRECT_MAX_VOCAB:
        logp = torch.log_softmax(lg / temperature, dim=-1)
        stopped_row = torch.full((V,), _NEG_INF, device=lg.device)
        stopped_row[0] = 0.0
        logp = torch.where(stopped, stopped_row, logp)
        avg = (scores[..., None] + logp) / new_len[..., None]
    else:
        inv_t = 1.0 / temperature
        rowmax = lg.amax(dim=-1)
        se = torch.exp((lg - rowmax[..., None]) * inv_t).sum(dim=-1)
        lse = rowmax * inv_t + torch.log(se)
        A = torch.where(is_stopped, 0.0, torch.full_like(new_len, inv_t) / new_len)
        Bc = torch.where(is_stopped, (scores + _NEG_INF) / new_len, (scores - lse) / new_len)
        avg = A[..., None] * lg + Bc[..., None]
        avg[..., 0] = torch.where(is_stopped, scores / new_len, avg[..., 0])
    top_avg, flat = _topk_argmax(avg.reshape(B, K * V), K)
    return top_avg, flat // V, flat % V, new_len


@torch.no_grad()
def _beam(params, prefix_embeds, K, entry_length, stop_token_id, temperature,
          cache, prefill, step):
    B, Lp, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    logits, cache = prefill(prefix_embeds, cache)
    cache = expand_beam_cache(cache, K)
    logp0 = torch.log_softmax(logits[:, -1].float() / temperature, dim=-1)
    scores, cur = _topk_argmax(logp0, K)                          # [B, K]
    tokens = torch.zeros(B, K, entry_length, dtype=torch.int64, device=dev)
    tokens[:, :, 0] = cur
    seq_lengths = torch.ones(B, K, device=dev)
    is_stopped = cur == stop_token_id
    for i in range(1, entry_length):
        if (i - 1) % CHECK_EVERY == 0 and bool(is_stopped.all()):
            break
        logits, cache = step(gpt2_embed(params, cur.reshape(-1)), cache, Lp + i - 1)
        top_avg, src, cur, new_len = _beam_select(
            logits, scores, seq_lengths, is_stopped, temperature, B, K)
        reorder_beam_cache(cache, src, Lp + i)
        tokens = tokens.gather(1, src[..., None].expand_as(tokens))
        tokens[:, :, i] = cur
        seq_lengths = new_len.gather(1, src)
        is_stopped = is_stopped.gather(1, src) | (cur == stop_token_id)
        scores = top_avg * seq_lengths
    return tokens, seq_lengths.long(), scores / seq_lengths


def beam_search_batched(params: dict, cfg: GPT2Config, prefix_embeds: torch.Tensor,
                        beam_size: int = 5, entry_length: int = 67,
                        stop_token_id: int = 13, temperature: float = 1.0):
    """Beam search over a clip batch ``prefix_embeds`` [B, Lp, D]. Returns
    (tokens [B, beam, entry_length] int64, seq_lengths [B, beam] int64,
    scores [B, beam] fp32 length-normalised), each clip's beams in
    descending score order."""
    B, Lp, _ = prefix_embeds.shape
    cache = init_kv_cache(cfg, B, Lp + entry_length, prefix_embeds.dtype,
                          prefix_embeds.device)
    return _beam(params, prefix_embeds, beam_size, entry_length, stop_token_id,
                 temperature, cache,
                 lambda e, c: gpt2_prefill(params, cfg, e, c),
                 lambda x, c, idx: gpt2_step(params, cfg, x, c, idx))


def beam_search_batched_q8(params: dict, cfg: GPT2Config, prefix_embeds: torch.Tensor,
                           beam_size: int = 5, entry_length: int = 67,
                           stop_token_id: int = 13, temperature: float = 1.0,
                           attention=decode_attn_q8):
    """``beam_search_batched`` over the int8 KV cache, each layer's attention
    through kernel K1 at B * beam rows (``attention=decode_attn_q8_plain``
    runs the plain version). ``params`` may be float or quantized
    (``quantize_gpt2_int8``)."""
    B, Lp, _ = prefix_embeds.shape
    cache = init_kv_cache_q8(cfg, B, Lp + entry_length, prefix_embeds.device)
    return _beam(params, prefix_embeds, beam_size, entry_length, stop_token_id,
                 temperature, cache,
                 lambda e, c: gpt2_prefill_q8(params, cfg, e, c),
                 lambda x, c, idx: gpt2_step_q8(params, cfg, x, c, idx, attention))


def beam_search(params: dict, cfg: GPT2Config, prefix_embeds: torch.Tensor,
                beam_size: int = 5, entry_length: int = 67, stop_token_id: int = 13,
                temperature: float = 1.0):
    """One clip (``prefix_embeds`` [1, Lp, D]): (tokens [beam, entry_length],
    seq_lengths [beam], scores [beam])."""
    tokens, seq_lengths, scores = beam_search_batched(
        params, cfg, prefix_embeds, beam_size, entry_length, stop_token_id, temperature)
    return tokens[0], seq_lengths[0], scores[0]
