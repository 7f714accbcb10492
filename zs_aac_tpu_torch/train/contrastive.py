"""The contrastive (CLAP) train step and the ASE encoders as the bank build
and retrieval call them.

The counterpart of the JAX package's ``train/contrastive.py``:

- ``ASETrainState`` (params, batch_stats, opt_state, step) and
  ``create_ase_state``;
- ``make_ase_train_step``: one step is the log-mel of the batch's waves
  (kernel K2 on the card; no gradient reaches the wave), the ASE loss in
  train mode, the backward (``torch.autograd``: fp32 gradients of the fp32
  parameter leaves, through the train kernels K5-K9 where the config
  dispatches them), the optimizer update and the new ``batch_stats``. The
  step's random draws (spec augmentation, drop path) come from a
  ``torch.Generator`` seeded with ``fold_in(seed, step)``, as the JAX step
  folds the step count into its key. Under a ``mesh`` (``parallel.mesh``)
  the step is data-parallel and still computes the one-process step of the
  global batch (``make_ase_train_step``'s docstring);
- ``make_encode_fns``: eval-mode encoders (audio through K2 and
  ``ASE.encode_audio``, text through ``ASE.encode_text``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from zs_aac_tpu_torch.models.ase import ASE, init_ase
from zs_aac_tpu_torch.models.convert import tree_map
from zs_aac_tpu_torch.ops.logmel import LogMelConfig, log_mel
from zs_aac_tpu_torch.parallel.mesh import all_reduce_grads, mesh_axis
from zs_aac_tpu_torch.train.optim import apply_updates, tree_leaves
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["ASETrainState", "create_ase_state", "make_ase_train_step", "make_encode_fns",
           "fold_in"]


@dataclasses.dataclass
class ASETrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: int


def fold_in(seed: int, step: int) -> int:
    """A generator seed for step ``step`` of a run seeded with ``seed``."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def create_ase_state(seed: int, ase: ASE, optimizer, device="cuda",
                     variables: Optional[dict] = None) -> ASETrainState:
    """A fresh train state: ``variables`` (or seeded random ones from
    ``init_ase``) with fp32 parameter leaves, the optimizer's initial state
    and step 0."""
    dev = resolve_device(device)
    if variables is None:
        variables = init_ase(ase.cfg, seed=seed, device=dev)
    params = tree_map(lambda t: t.detach().to(dev, torch.float32), variables["params"])
    stats = tree_map(lambda t: t.detach().to(dev), variables.get("batch_stats", {}))
    return ASETrainState(params, stats, optimizer.init(params), 0)


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_ase_train_step(ase: ASE, optimizer, mel_cfg: Optional[LogMelConfig] = None,
                        device="cuda", mesh=None):
    """``train_step(state, batch, seed) -> (new_state, loss)``. ``batch``:
    {"wave": [B, T] float32, "input_ids": [B, L], "attention_mask": [B, L],
    "idx": [B]} (numpy or tensors; moved to ``device``).

    Under ``mesh`` (its ``data`` dim) ``batch`` is this rank's rows of the
    global batch (``parallel.mesh.shard_batch``) and every rank passes the
    same state and ``seed``. The step is then the one-process step of the
    global batch: the loss over the gathered embeddings, global batch
    statistics and random draws (``ASE.__call__``), and each rank
    differentiates 1 / size of that replicated loss, so the gradients summed
    over ``data`` are the one-process gradients. Every rank ends with the
    same state; the loss returned is the global batch's."""
    dev = resolve_device(device)
    mel_cfg = mel_cfg or LogMelConfig()
    data = mesh_axis(mesh, "data")

    def train_step(state: ASETrainState, batch, seed: int):
        g = torch.Generator(device=dev).manual_seed(fold_in(seed, state.step))
        take = lambda k: torch.as_tensor(batch[k]).to(dev)
        with torch.no_grad():
            spec = log_mel(take("wave").float().contiguous(), mel_cfg)[:, 0]
        params = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        loss, new_stats = ase({"params": params, "batch_stats": state.batch_stats}, spec,
                              take("input_ids"), take("attention_mask"), take("idx"),
                              train=True, generator=g, data=data)
        leaves = tree_leaves(params)
        share = loss if data is None else loss / data.size
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
        grads = _unflatten(params, all_reduce_grads(
            [torch.zeros_like(p) if gr is None else gr for p, gr in zip(leaves, grads)], data))
        detached = tree_map(lambda t: t.detach(), params)
        updates, opt_state = optimizer.update(grads, state.opt_state, detached)
        new_params = apply_updates(detached, updates)
        return ASETrainState(new_params, new_stats, opt_state, state.step + 1), loss.detach()

    return train_step


def make_encode_fns(ase: ASE, mel_cfg: Optional[LogMelConfig] = None, device="cuda"):
    """Eval-mode ``(encode_audio(variables, wave [B, T]), encode_text(
    variables, input_ids, attention_mask))``, each returning [B, embed_size];
    inputs are moved to ``device``."""
    dev = resolve_device(device)
    mel_cfg = mel_cfg or LogMelConfig()

    @torch.no_grad()
    def encode_audio(variables, wave):
        spec = log_mel(torch.as_tensor(wave).to(dev), mel_cfg)[:, 0]
        return ase.encode_audio(variables, spec)

    @torch.no_grad()
    def encode_text(variables, input_ids, attention_mask):
        return ase.encode_text(variables, torch.as_tensor(input_ids).to(dev),
                               torch.as_tensor(attention_mask).to(dev))

    return encode_audio, encode_text
