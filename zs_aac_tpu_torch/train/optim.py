"""Learning-rate schedules and optimizers with optax's arithmetic.

The counterpart of the JAX package's ``train/optim.py`` (the reference
``tools/optim_utils.py``): ``cosine_lr``, ``step_lr`` and
``linear_warmup_lr`` are functions of the update count (from 0), and
``get_optimizer`` builds ``adam``, ``adamw`` or ``sgd`` as optax builds them.
An optimizer is a pair ``(init(params) -> state, update(grads, state,
params) -> (updates, state))`` over trees (nested dicts) of tensors, applied
with ``apply_updates``; ``chain``, ``clip_by_global_norm``,
``multi_transform`` and ``set_to_zero`` compose them as optax's do. States
are plain dicts and tuples of tensors (``torch.save``-able).

What is optax's and not ``torch.optim``'s: Adam's ``eps`` is added outside
the square root and the bias corrections divide the moments; AdamW's decay
is decoupled and applied to every leaf (``g + wd * p`` before the learning
rate); the schedule is read at the count before the update; and
``clip_by_global_norm`` scales by ``max_norm / norm`` only where the norm is
not below ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm and is another function).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["cosine_lr", "step_lr", "linear_warmup_lr", "get_optimizer", "chain",
           "clip_by_global_norm", "multi_transform", "set_to_zero", "apply_updates",
           "tree_leaves", "GradientTransformation"]


def cosine_lr(base_lr: float, warmup_length: int, steps: int):
    """lr(step): linear warmup then cosine to 0."""

    def schedule(step):
        if step < warmup_length:
            return base_lr * (step + 1) / max(warmup_length, 1)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr

    return schedule


def step_lr(base_lr: float, warmup_length: int, adjust_steps: int, gamma: float):
    """lr(step): warmup, then times ``gamma`` every ``adjust_steps``."""

    def schedule(step):
        if step < warmup_length:
            return base_lr * (step + 1) / max(warmup_length, 1)
        return base_lr * gamma ** (max(step - warmup_length, 0) // adjust_steps)

    return schedule


def linear_warmup_lr(base_lr: float, warmup_steps: int, total_steps: int):
    """HF ``get_linear_schedule_with_warmup``."""

    def schedule(step):
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        return base_lr * max(total_steps - step, 0) / max(total_steps - warmup_steps, 1)

    return schedule


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves(tree):
    """Leaves of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in each parameter's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": _map(torch.zeros_like, params), "nu": _map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        c1 = (1 - _f32(b1) ** count.float())
        c2 = (1 - _f32(b2) ** count.float())
        updates = _map(lambda m, v: (m / c1.to(m)) / (torch.sqrt(v / c2.to(v)) + eps), mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float):
    def update(grads, state, params=None):
        return _map(lambda g, p: g + weight_decay * p, grads, params), state

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(schedule):
    """``updates * -lr(count)``, the count read before it is incremented."""
    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32)}

    def update(grads, state, params=None):
        lr = schedule(int(state["count"])) if callable(schedule) else schedule
        step = torch.tensor(-1.0 * lr, dtype=torch.float32)
        return (_map(lambda g: step.to(g) * g, grads), {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def trace(decay: float):
    def init(params):
        return {"trace": _map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        new = _map(lambda g, t: g + decay * t, grads, state["trace"])
        return new, {"trace": new}

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float):
    """``g * max_norm / norm`` where the global norm is not below ``max_norm``."""
    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        if not leaves:
            return grads, state
        norm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
        if bool(norm < max_norm):
            return grads, state
        return _map(lambda g: (g / norm.to(g.dtype)) * max_norm, grads), state

    return GradientTransformation(lambda params: {}, update)


def chain(*transforms):
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def set_to_zero():
    """Zero updates, as expanded views of one zero (no memory per leaf: a
    frozen 7B base costs nothing)."""
    def zeros(g):
        return torch.zeros((), dtype=g.dtype, device=g.device).expand(g.shape)

    return GradientTransformation(lambda params: {},
                                  lambda grads, state, params=None: (_map(zeros, grads), state))


def _part(tree, lab, name):
    """The subtree of ``tree`` whose labels are ``name`` (None if empty)."""
    if isinstance(lab, str):
        return tree if lab == name else None
    out = {}
    for k in tree:
        sub = _part(tree[k], lab[k], name)
        if sub is not None:
            out[k] = sub
    return out or None


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def multi_transform(transforms: dict, labels: Callable):
    """optax's ``multi_transform``: ``labels(tree)`` names a transform for
    each key of the tree, a string for its whole subtree or a dict of labels
    one level down; each transform sees its part of the tree."""
    def groups(tree):
        lab = labels(tree)
        return {name: _part(tree, lab, name) or {} for name in transforms}

    def init(params):
        return {name: transforms[name].init(sub) for name, sub in groups(params).items()}

    def update(grads, state, params=None):
        gg = groups(grads)
        pp = groups(params) if params is not None else {n: None for n in transforms}
        out, new = {}, {}
        for name, t in transforms.items():
            u, new[name] = t.update(gg[name], state[name], pp[name])
            _merge(out, u)
        return out, new

    return GradientTransformation(init, update)


def get_optimizer(schedule, optimizer_name: str = "adamw", betas=(0.9, 0.999),
                  eps: float = 1e-8, momentum: float = 0.9, weight_decay: float = 0.0):
    """optax's ``adamw``, ``adam`` or ``sgd`` with this schedule."""
    name = optimizer_name.lower()
    if name == "adamw":
        return chain(scale_by_adam(betas[0], betas[1], eps), add_decayed_weights(weight_decay),
                     scale_by_learning_rate(schedule))
    if name == "adam":
        return chain(scale_by_adam(betas[0], betas[1], eps), scale_by_learning_rate(schedule))
    if name == "sgd":
        return chain(trace(momentum), scale_by_learning_rate(schedule))
    raise ValueError("optimizer name is not correct")
