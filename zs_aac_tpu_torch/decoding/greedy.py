"""Greedy decoding over a KV cache.

The counterpart of the JAX package's ``decoding/greedy.py``: pure argmax
(the reference's nucleus filter always keeps the argmax, so it is a no-op),
stop on ``stop_token_id`` and the reference's hardcoded 764. ``lengths``
counts emitted tokens including the stop token; tokens after a stop are 0.

The loop runs on the host, one prefill and up to ``entry_length`` cached
steps. One cache of ``Lp + entry_length`` rows replaces the JAX package's
staged cache (a TPU layout choice; each step reads only its valid rows
here). The loop leaves early once every row has stopped, checking every
``CHECK_EVERY`` steps so that it does not wait on the device each step.

``mistral_greedy_decode`` is the Mistral captioner's decode (eos 2, at most
60 new tokens, the EOS itself not emitted), over the float or the int8 KV
cache, with the same full-length cache and early exit.

Spans (``utils/profiling.py``): ``decode.prefill`` over the cache's
allocation, the prefill with its cache quantize and the first argmax;
``decode.step`` over each cached step (the token's record, the embed, the
model step, the argmax); ``decode.stop_check`` over each host read of
"every row has stopped".
"""

from __future__ import annotations

import torch

from zs_aac_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_embed,
    gpt2_prefill,
    gpt2_prefill_q8,
    gpt2_step,
    gpt2_step_q8,
    init_kv_cache,
    init_kv_cache_q8,
)
from zs_aac_tpu_torch.ops.decode_attn import decode_attn_q8
from zs_aac_tpu_torch.utils.profiling import annotate

__all__ = ["CHECK_EVERY", "greedy_decode", "greedy_decode_q8", "mistral_greedy_decode"]

CHECK_EVERY = 8  # steps between host checks for "every row has stopped"


def _all_stopped(finished) -> bool:
    """The host's wait for the device: has every row stopped?"""
    with annotate("decode.stop_check"):
        return bool(finished.all())


@torch.no_grad()
def _greedy(params, prefix_embeds, entry_length, stop_token_id, extra_stop_id,
            init_cache, prefill, step, tp=None):
    B, Lp, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    with annotate("decode.prefill"):
        logits, cache = prefill(prefix_embeds, init_cache())
        cur = logits[:, -1].argmax(dim=-1)
        tokens = torch.zeros(B, entry_length, dtype=torch.int64, device=dev)
        lengths = torch.zeros(B, dtype=torch.int64, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(entry_length):
        if i and i % CHECK_EVERY == 0 and _all_stopped(finished):
            break
        with annotate("decode.step"):
            tokens[:, i] = torch.where(finished, 0, cur)
            lengths += (~finished).long()
            finished = finished | (cur == stop_token_id) | (cur == extra_stop_id)
            logits, cache = step(gpt2_embed(params, cur, tp), cache, Lp + i)
            cur = logits.argmax(dim=-1)
    return tokens, lengths


def greedy_decode(params: dict, cfg: GPT2Config, prefix_embeds: torch.Tensor,
                  entry_length: int = 67, stop_token_id: int = 13,
                  extra_stop_id: int = 764, tp=None):
    """Returns (tokens [B, entry_length] int64, lengths [B] int64). Under
    ``tp`` (the ``model`` axis of a mesh) ``params`` is this rank's shard
    (``parallel.tp.shard_gpt2_params``) and every rank of the group decodes
    the same prefixes to the same tokens."""
    B, Lp, _ = prefix_embeds.shape
    return _greedy(
        params, prefix_embeds, entry_length, stop_token_id, extra_stop_id,
        lambda: init_kv_cache(cfg, B, Lp + entry_length, prefix_embeds.dtype,
                              prefix_embeds.device, tp),
        lambda e, c: gpt2_prefill(params, cfg, e, c, tp=tp),
        lambda x, c, idx: gpt2_step(params, cfg, x, c, idx, tp=tp), tp)


def greedy_decode_q8(params: dict, cfg: GPT2Config, prefix_embeds: torch.Tensor,
                     entry_length: int = 67, stop_token_id: int = 13,
                     extra_stop_id: int = 764, attention=decode_attn_q8):
    """Greedy decode over the int8 KV cache, each layer's attention through
    kernel K1 (``gpt2_step_q8``; ``attention=decode_attn_q8_plain`` runs the
    plain version). ``params`` may be float or quantized
    (``quantize_gpt2_int8``). Same returns as ``greedy_decode``."""
    B, Lp, _ = prefix_embeds.shape
    return _greedy(
        params, prefix_embeds, entry_length, stop_token_id, extra_stop_id,
        lambda: init_kv_cache_q8(cfg, B, Lp + entry_length, prefix_embeds.device),
        lambda e, c: gpt2_prefill_q8(params, cfg, e, c),
        lambda x, c, idx: gpt2_step_q8(params, cfg, x, c, idx, attention))


@torch.no_grad()
def mistral_greedy_decode(params: dict, cfg, prefix_embeds: torch.Tensor, lora=None,
                          max_new_tokens: int = 60, eos_token_id: int = 2, *,
                          q8_cache: bool = False, tp=None):
    """Batched greedy decode of the Mistral captioner (``cfg`` a
    ``MistralConfig``; ``params`` float or ``quantize_mistral_int8``'s).
    Returns (tokens [B, max_new_tokens] int64, lengths [B] int64): a row's
    tokens up to its EOS, which is not emitted, then 0; ``lengths`` counts
    the steps each row was still running. ``q8_cache`` serves over the int8
    KV cache. Under ``tp`` (float weights and cache) ``params`` and ``lora``
    are this rank's shards (``parallel.tp``)."""
    from zs_aac_tpu_torch.models.mistral import (init_mistral_cache, init_mistral_cache_q8,
                                                 mistral_embed, mistral_prefill, mistral_step)

    B, Lp, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    with annotate("decode.prefill"):
        if lora is not None:
            # the matmul sites cast LoRA's a/b to the activation dtype; do it once
            lora = _cast_matrices(lora, prefix_embeds.dtype)
        T = Lp + max_new_tokens
        cache = (init_mistral_cache_q8(cfg, B, T, dev) if q8_cache
                 else init_mistral_cache(cfg, B, T, prefix_embeds.dtype, dev, tp))
        logits, cache = mistral_prefill(params, cfg, prefix_embeds, cache, lora=lora, tp=tp)
        cur = logits[:, -1].argmax(dim=-1)
        tokens = torch.zeros(B, max_new_tokens, dtype=torch.int64, device=dev)
        lengths = torch.zeros(B, dtype=torch.int64, device=dev)
        finished = cur == eos_token_id
    for i in range(max_new_tokens):
        if i % CHECK_EVERY == 0 and _all_stopped(finished):
            break
        if i == max_new_tokens - 1:   # the last step's logits would choose no token
            tokens[:, i] = torch.where(finished, 0, cur)
            lengths += (~finished).long()
            break
        with annotate("decode.step"):
            tokens[:, i] = torch.where(finished, 0, cur)
            lengths += (~finished).long()
            logits, cache = mistral_step(params, cfg, mistral_embed(params, cur, tp), cache,
                                         Lp + i, lora=lora, tp=tp)
            cur = logits.argmax(dim=-1)
            finished = finished | (cur == eos_token_id)
    return tokens, lengths


def _cast_matrices(tree, dtype):
    """LoRA's a/b matrices in ``dtype`` (the 0-d ``r``/``alpha`` kept)."""
    if isinstance(tree, dict):
        return {k: _cast_matrices(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_matrices(v, dtype) for v in tree]
    return tree.to(dtype) if tree.ndim == 2 else tree
