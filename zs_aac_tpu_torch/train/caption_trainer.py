"""The captioner's train step.

The counterpart of the JAX package's ``train/caption_trainer.py``: one step
injects noise into the CLAP prefix (``utils/noise.py``), runs the training
forward through [hard prompt | mapper prefix | caption tokens], takes the
next-token cross-entropy with token 0 ignored, its gradients by autograd,
and an AdamW update with the port's optax arithmetic (``train/optim.py``).
``only_prefix`` freezes GPT-2 by an optimizer partition (``set_to_zero``):
GPT-2 gets no gradient, no update and no decay, and stays in the tree.

The parameters stay ``{"mapper": nn.Module, "gpt2": dict, ...}`` and are
updated in place (``p + u``, the optax ``apply_updates`` arithmetic); the
optimizer sees them through ``tensor_tree``, which shares their storage. The
step's noise comes from a ``torch.Generator`` seeded with ``fold_in(seed,
step)``, as the JAX step folds the step count into its key.

Under a ``mesh`` (``parallel.mesh``, dims ``data`` x ``model``) the step is
the JAX package's dp x tp captioner step: GPT-2 is this rank's Megatron
shard (``parallel.tp.shard_gpt2_params``), the mapper is replicated, each
rank takes its ``data`` rows, and the step computes the one-process step
of the global batch (``make_caption_train_step``'s docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from zs_aac_tpu_torch.models.caption import (CaptionConfig, caption_loss, caption_train_logits,
                                             init_caption_model, trainable_filter)
from zs_aac_tpu_torch.parallel.mesh import all_reduce_grads, all_sum, mesh_axis, tensor_axis
from zs_aac_tpu_torch.train.contrastive import fold_in
from zs_aac_tpu_torch.train.optim import (get_optimizer, multi_transform, set_to_zero,
                                          tree_leaves)
from zs_aac_tpu_torch.utils.device import resolve_device
from zs_aac_tpu_torch.utils.noise import noise_injection

__all__ = ["CaptionTrainState", "tensor_tree", "make_caption_optimizer",
           "create_caption_state", "make_caption_train_step"]


@dataclasses.dataclass
class CaptionTrainState:
    params: Any      # {"mapper": nn.Module, "gpt2": dict, ...}, updated in place
    opt_state: Any
    step: int


def tensor_tree(params):
    """The parameter tensors of a caption model as nested dicts (a module by
    its ``named_parameters``, a list keyed "0", "1", ...), sharing storage."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, dict):
        return {k: tensor_tree(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return {str(i): tensor_tree(v) for i, v in enumerate(params)}
    return params


def make_caption_optimizer(cfg: CaptionConfig, schedule, weight_decay: float = 0.0):
    """optax's ``adamw`` (lr 1e-5, decay 0 in the reference); with
    ``only_prefix`` GPT-2 goes to ``set_to_zero``."""
    opt = get_optimizer(schedule, "adamw", weight_decay=weight_decay)
    if not cfg.only_prefix:
        return opt
    return multi_transform({"trainable": opt, "frozen": set_to_zero()}, trainable_filter(cfg))


def create_caption_state(seed: int, cfg: CaptionConfig, optimizer,
                         gpt2_params: Optional[dict] = None, device="cuda") -> CaptionTrainState:
    """Seeded random caption model (or GPT-2 from ``gpt2_params``) with fp32
    parameters, the optimizer's initial state and step 0."""
    params = init_caption_model(cfg, seed, device, gpt2_params=gpt2_params)
    return CaptionTrainState(params, optimizer.init(tensor_tree(params)), 0)


def make_caption_train_step(cfg: CaptionConfig, optimizer, noise_variance: float = 0.016,
                            uniform_noise: bool = False, dont_norm: bool = False,
                            device="cuda", mesh=None):
    """``train_step(state, batch, seed) -> (state, loss)``. ``batch``:
    {"tokens": [B, S], "mask": [B, P + S], "prefix": [B, E], optional
    "hard_prompt": [B, H] and "hard_mask": [B, H]} (numpy or tensors; moved
    to ``device``). The parameters are updated in place.

    Under ``mesh`` ``batch`` is this rank's ``data`` rows
    (``parallel.mesh.shard_batch``), every rank passes the same ``seed``,
    and ``state.params["gpt2"]`` is this rank's shard over ``model`` (the
    whole GPT-2 where ``model`` has one rank: ``tensor_axis``). The
    noise is drawn for the global batch, each rank differentiates its share
    of the global loss (``caption_loss``), and the gradients are summed over
    ``data``: each rank holds the one-process gradients of its own shard
    and of the replicated leaves. The loss returned is the global batch's."""
    dev = resolve_device(device)
    frozen = {"gpt2"} if cfg.only_prefix else set()
    data, tp = mesh_axis(mesh, "data"), tensor_axis(mesh)

    def train_step(state: CaptionTrainState, batch, seed: int):
        g = torch.Generator(device=dev).manual_seed(fold_in(seed, state.step))
        take = lambda k: torch.as_tensor(batch[k]).to(dev) if k in batch else None
        tree = tensor_tree(state.params)
        trained = {k: tree_leaves(v) for k, v in tree.items() if k not in frozen}
        leaves = [p for ps in trained.values() for p in ps]
        with torch.enable_grad():
            for k, v in tree.items():
                for p in tree_leaves(v):
                    p.requires_grad_(k not in frozen)
            tokens = take("tokens")
            prefix = noise_injection(take("prefix").float(), noise_variance, uniform_noise,
                                     dont_norm, generator=g, data=data)
            logits = caption_train_logits(state.params, cfg, tokens, prefix, take("mask"),
                                          take("hard_prompt"), take("hard_mask"), tp=tp)
            share = caption_loss(logits, tokens, data)
            grads = torch.autograd.grad(share, leaves, allow_unused=True)
        it = iter(all_reduce_grads([torch.zeros_like(p) if gr is None else gr
                                    for p, gr in zip(leaves, grads)], data))
        # a frozen group's "gradients" are its parameters: set_to_zero reads
        # only their shapes
        grad_tree = {k: _like(v, it) if k not in frozen else v for k, v in tree.items()}
        with torch.no_grad():
            updates, opt_state = optimizer.update(grad_tree, state.opt_state, tree)
            for k in trained:
                for p, u in zip(tree_leaves(tree[k]), tree_leaves(updates[k])):
                    p.add_(u)
        loss = all_sum(share.detach(), data)
        return CaptionTrainState(state.params, opt_state, state.step + 1), loss

    return train_step


def _like(tree, it):
    if isinstance(tree, dict):
        return {k: _like(v, it) for k, v in tree.items()}
    return next(it)
