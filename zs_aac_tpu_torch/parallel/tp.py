"""Megatron tensor parallelism for the GPT-2 and Mistral decoders.

The counterpart of the JAX package's ``parallel/tp.py``. There the layout is
a set of ``NamedSharding`` annotations and GSPMD inserts the collectives;
here each rank of a mesh's ``model`` dim holds its shard of the parameters
(``shard_gpt2_params``, ``shard_mistral_params``, ``shard_mistral_lora``)
and the models run Megatron's f / g around the parallel products
(``models/gpt2.py``, ``models/mistral.py``). Splits follow the heads, not
the fused columns: GPT-2's ``c_attn`` [D, 3D] is split in q, k and v
separately, so that rank r holds whole heads of each.

GPT-2 (float weights only, as in the JAX package):

- ``c_attn`` by heads (q, k, v each), ``c_fc`` by columns: column-parallel;
- both ``c_proj`` by rows, their biases whole (added once, after g);
- ``wte`` by vocabulary rows (padded with zero rows to a multiple of the
  group), tied to the logits;
- layer norms and ``wpe`` whole.

Mistral: ``wq``/``wk``/``wv`` by heads (``n_kv_heads`` must divide by the
group), ``gate``/``up`` by columns, ``wo``/``down`` by rows, ``embed`` by
vocabulary rows and ``lm_head`` by vocabulary columns (both padded), norms
whole. The fused serving leaves (``wqkv``, ``gateup``) and int8 weights are
not sharded. A LoRA site follows its base: at a column-parallel site ``b``
is split by columns and ``a`` stays whole (behind f, so its gradient sums
over the group); at a row-parallel site ``a`` is split by rows and its delta
joins the partial sum before g (``b`` whole, behind f).

``unshard_gpt2_params`` and ``unshard_mistral_lora`` are the inverses (an
``all_gather`` over the group): the whole tree on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from zs_aac_tpu_torch.parallel.mesh import Axis, mesh_axis, tp_reduce

__all__ = ["shard_gpt2_params", "unshard_gpt2_params", "shard_mistral_params",
           "shard_mistral_lora", "unshard_mistral_lora", "embed_lookup", "model_axis"]


def model_axis(mesh_or_axis) -> Optional[Axis]:
    """The ``model`` axis of a mesh (an ``Axis`` passes through)."""
    if mesh_or_axis is None or isinstance(mesh_or_axis, Axis):
        return mesh_or_axis
    return mesh_axis(mesh_or_axis, "model")


def embed_lookup(table, tokens, tp: Optional[Axis]):
    """A vocabulary-parallel embedding: each rank looks up the ids of its
    rows of ``table``, the others give 0, and g sums them (exact)."""
    if tp is None:
        return table[tokens]
    local = tokens - tp.rank * table.shape[0]
    inside = (local >= 0) & (local < table.shape[0])
    e = table[torch.where(inside, local, 0)]
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    return tp_reduce(torch.where(inside[..., None], e, zero), tp)


# A rule is (dim, parts, whole): split ``dim`` in ``parts`` equal blocks (q,
# k, v) and each block over the group; ``whole`` is the size to cut a padded
# dim back to (the vocabulary), or None. No rule: the leaf stays whole.

def _shard(t, rule, tp: Axis):
    dim, parts, whole = rule
    if whole is not None:
        pad = -t.shape[dim] % tp.size
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    blocks = t.chunk(parts, dim=dim)
    if blocks[0].shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not split over "
                         f"{tp.size} ranks")
    return torch.cat([b.chunk(tp.size, dim=dim)[tp.rank] for b in blocks],
                     dim=dim).contiguous().clone()


def _unshard(t, rule, tp: Axis):
    dim, parts, whole = rule
    shards = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(shards, t.contiguous(), group=tp.group)
    pieces = [s.chunk(parts, dim=dim) for s in shards]
    out = torch.cat([torch.cat([p[j] for p in pieces], dim=dim) for j in range(parts)], dim=dim)
    return out.narrow(dim, 0, whole) if whole is not None else out


def _walk(tree, rule_of, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, rule_of, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, rule_of, fn, path + (i,)) for i, v in enumerate(tree)]
    rule = rule_of(path)
    return tree if rule is None else fn(tree, rule)


def _float_only(tree, what):
    bad = []
    _walk(tree, lambda p: p, lambda t, p: bad.append(p) if not t.is_floating_point() else None)
    if bad:
        raise ValueError(f"{what}: tensor parallelism takes float weights only (int8 at "
                         f"{bad[0]})")


def _gpt2_rule(cfg):
    per_layer = {("attn", "c_attn", "w"): (1, 3, None), ("attn", "c_attn", "b"): (0, 3, None),
                 ("attn", "c_proj", "w"): (0, 1, None),
                 ("mlp", "c_fc", "w"): (1, 1, None), ("mlp", "c_fc", "b"): (0, 1, None),
                 ("mlp", "c_proj", "w"): (0, 1, None)}

    def rule(path):
        if path == ("wte",):
            return 0, 1, cfg.vocab_size
        return per_layer.get(path[2:]) if path[0] == "h" else None

    return rule


def shard_gpt2_params(params: dict, cfg, mesh) -> dict:
    """This rank's Megatron shard (module docstring) of the full float
    GPT-2 ``params``; ``mesh`` a mesh with a ``model`` dim or its ``Axis``."""
    tp = model_axis(mesh)
    if "wte_q" in params:
        raise ValueError("shard_gpt2_params: tensor parallelism takes float weights only")
    _float_only(params, "shard_gpt2_params")
    if cfg.n_head % tp.size:
        raise ValueError(f"{cfg.n_head} heads do not split over {tp.size} ranks")
    return _walk(params, _gpt2_rule(cfg), lambda t, r: _shard(t, r, tp))


def unshard_gpt2_params(params: dict, cfg, mesh) -> dict:
    """The full GPT-2 tree from every rank's shard (every rank calls it)."""
    tp = model_axis(mesh)
    return _walk(params, _gpt2_rule(cfg), lambda t, r: _unshard(t, r, tp))


_MISTRAL_COL = ("wq", "wk", "wv", "gate", "up")
_MISTRAL_ROW = ("wo", "down")


def _mistral_rule(cfg):
    def rule(path):
        if path == ("embed",):
            return 0, 1, cfg.vocab_size
        if path == ("lm_head",):
            return 1, 1, cfg.vocab_size
        if path[0] == "layers" and path[-1] in _MISTRAL_COL:
            return 1, 1, None
        if path[0] == "layers" and path[-1] in _MISTRAL_ROW:
            return 0, 1, None
        return None

    return rule


def _lora_rule(cfg):
    def rule(path):
        if path == ("lm_head", "b"):
            return 1, 1, cfg.vocab_size
        if path[0] == "layers" and path[-2] in _MISTRAL_COL and path[-1] == "b":
            return 1, 1, None
        if path[0] == "layers" and path[-2] in _MISTRAL_ROW and path[-1] == "a":
            return 0, 1, None
        return None

    return rule


def _check_mistral(cfg, tp: Axis):
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("intermediate_size", cfg.intermediate_size)):
        if n % tp.size:
            raise ValueError(f"Mistral {name} = {n} does not split over {tp.size} ranks")


def shard_mistral_params(params: dict, cfg, mesh) -> dict:
    """This rank's Megatron shard (module docstring) of the full float
    Mistral ``params``; the fused serving layout and int8 weights raise."""
    tp = model_axis(mesh)
    _check_mistral(cfg, tp)
    for layer in params["layers"]:
        if "wqkv" in layer["attn"] or "gateup" in layer["mlp"]:
            raise ValueError("shard_mistral_params: the fused wqkv/gateup serving leaves "
                             "are not sharded; shard the unfused float weights")
    if isinstance(params["lm_head"], dict):
        raise ValueError("shard_mistral_params: tensor parallelism takes float weights only")
    _float_only(params, "shard_mistral_params")
    return _walk(params, _mistral_rule(cfg), lambda t, r: _shard(t, r, tp))


def shard_mistral_lora(lora: dict, cfg, mesh) -> dict:
    """This rank's shard of a LoRA tree (``init_lora``'s), each site split
    as its base weight is (module docstring)."""
    tp = model_axis(mesh)
    _check_mistral(cfg, tp)
    return _walk(lora, _lora_rule(cfg), lambda t, r: _shard(t, r, tp))


def unshard_mistral_lora(lora: dict, cfg, mesh) -> dict:
    """The full LoRA tree from every rank's shard (every rank calls it)."""
    tp = model_axis(mesh)
    return _walk(lora, _lora_rule(cfg), lambda t, r: _unshard(t, r, tp))
