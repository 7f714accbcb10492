#!/usr/bin/env python3
"""Convert the JAX package's orbax train state into the PyTorch port's.

The JAX package's retrieval drivers keep their train states as orbax
checkpoint directories (``zs_aac_tpu/utils/checkpoints.py::save_train_state``:
``pretrain``'s ``best_model``/``last_model``/preemption directories,
``finetune``'s ``best_model``). The port keeps a train state as one
``torch.save`` file (``zs_aac_tpu_torch/utils/checkpoints.py``) and cannot
read orbax itself: orbax's reader needs tensorstore, which a machine that
runs only the port need not have. This script runs where the JAX package
runs and carries a directory across:

- it builds the restore template the JAX driver builds from the same config
  (``build_ase_from_config``, ``create_ase_state`` under ``jax.eval_shape``:
  its shapes and dtypes, without running the init; the driver's optimizer
  chain: ``pretrain``'s with ``clip_grad`` and the freezes, or
  ``finetune``'s plain one) and restores the directory with the JAX
  package's ``restore_train_state``;
- it writes ``{"params", "batch_stats", "opt_state", "step"}`` with the
  port's ``save_train_state``: the parameter and batch-statistics trees leaf
  for leaf (``models.convert.from_jax_params``), and the optimizer state in
  the port's layout (``zs_aac_tpu_torch/train/optim.py``): each optax state
  NamedTuple becomes a dict of its fields (``count``, ``mu``, ``nu``,
  ``trace``), ``MultiTransformState``/``MaskedState`` their inner states
  (the masked-out leaves dropped, as the port's ``multi_transform`` keeps
  only its part of the tree), and ``EmptyState`` what the port's ``init``
  gives that link of the chain. Every leaf keeps its bits.

The file feeds every reader of the port: ``restore_train_state`` (pretrain
``--resume_ckpt``), ``restore_model_only`` (finetune ``pretrain_path``) and
``load_ase_variables`` (``pipeline.extract``, ``eval.zero_shot --ckpt``).

Run (with the JAX package installed):
    python examples/convert_jax_state.py -c CONFIG.yaml --orbax_dir DIR --out FILE
        [--driver pretrain|finetune]   (the driver that wrote DIR; default pretrain)
``convert_jax_state(orbax_dir, config, driver)`` returns the payload.
"""

import argparse
import os
import sys
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

__all__ = ["convert_jax_state", "main"]


def _optimizers(config, driver, steps_per_epoch=1):
    """The driver's optimizer in each package, (JAX's, the port's), with the
    driver's schedule at ``steps_per_epoch`` (the schedule does not enter the
    state's layout)."""
    from zs_aac_tpu.train import optim as jopt
    from zs_aac_tpu.train.pretrain import apply_freeze
    from zs_aac_tpu_torch.train import optim as topt
    from zs_aac_tpu_torch.train.pretrain import build_optimizer

    optim, training = config["optim_args"], config["training"]
    lr, epochs = optim["lr"], training["epochs"]
    warmup = training.get("warmup_epochs", 2) * steps_per_epoch
    name = optim.get("optimizer_name", "adamw")
    if driver == "finetune":
        return (jopt.get_optimizer(jopt.cosine_lr(lr, warmup, epochs * steps_per_epoch), name),
                topt.get_optimizer(topt.cosine_lr(lr, warmup, epochs * steps_per_epoch), name))
    if driver != "pretrain":
        raise ValueError(f"unknown driver {driver!r}: pretrain or finetune")
    if optim.get("scheduler", "cosine") == "cosine":
        schedule = jopt.cosine_lr(lr, warmup, epochs * steps_per_epoch)
    else:
        schedule = jopt.step_lr(lr, warmup, steps_per_epoch * 10, 0.1)
    jax_opt = jopt.get_optimizer(schedule, name, tuple(optim.get("betas", (0.9, 0.999))),
                                 optim.get("eps", 1e-8), optim.get("momentum", 0.9),
                                 optim.get("weight_decay", 0.0))
    if training.get("clip_grad"):
        import optax

        jax_opt = optax.chain(optax.clip_by_global_norm(float(training["clip_grad"])), jax_opt)
    return apply_freeze(jax_opt, config), build_optimizer(config, steps_per_epoch)


def _leaf(a, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"optimizer leaf {t.dtype} {tuple(t.shape)} where the port's "
                         f"optimizer keeps {like.dtype} {tuple(like.shape)}")
    return t


def _opt_state(node, like):
    """The JAX optimizer state ``node`` (numpy leaves) in the layout of the
    port's state ``like``, walked together."""
    fields = getattr(node, "_fields", None)
    if fields is not None:                       # an optax state NamedTuple
        if not fields:                           # EmptyState: the port's own init
            return like
        if fields in (("inner_state",), ("inner_states",)):
            return _opt_state(getattr(node, fields[0]), like)
        if not isinstance(like, dict) or set(like) != set(fields):
            raise ValueError(f"{type(node).__name__}{fields} where the port's optimizer keeps "
                             f"{like!r:.80}")
        return {f: _opt_state(getattr(node, f), like[f]) for f in fields}
    if isinstance(like, dict):                   # the port's keys: masked leaves drop out
        return {k: _opt_state(node[k], v) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if len(node) != len(like):
            raise ValueError(f"a chain of {len(node)} states where the port's has {len(like)}")
        return tuple(_opt_state(n, v) for n, v in zip(node, like))
    return _leaf(node, like)


def convert_jax_state(orbax_dir: str, config: dict, driver: str = "pretrain") -> dict:
    """The JAX package's orbax train state at ``orbax_dir``, written by the
    ``driver`` run with ``config``, as the port's train-state payload
    ``{"params", "batch_stats", "opt_state", "step"}`` (CPU tensors)."""
    import jax

    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train.contrastive import create_ase_state
    from zs_aac_tpu.train.pretrain import build_ase_from_config
    from zs_aac_tpu.utils.checkpoints import restore_train_state
    from zs_aac_tpu_torch.models.convert import from_jax_params

    jax_opt, port_opt = _optimizers(config, driver)
    ase, _ = build_ase_from_config(config)
    mel = LogMelConfig.from_dict(config["audio_args"])
    # the template's shapes and dtypes are all a restore reads: traced, not run
    template = jax.eval_shape(lambda: create_ase_state(
        jax.random.key(0), ase, jax_opt, spec_shape=(2, 101, mel.n_mels), text_len=30))
    state = jax.device_get(restore_train_state(orbax_dir, template))
    variables = from_jax_params({"params": state.params, "batch_stats": state.batch_stats},
                                device="cpu")
    return {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt_state": _opt_state(state.opt_state, port_opt.init(variables["params"])),
            "step": int(state.step)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="the config the JAX driver ran")
    p.add_argument("--orbax_dir", required=True, help="the JAX driver's train-state directory")
    p.add_argument("--out", required=True, help="the port's train-state file to write")
    p.add_argument("--driver", default="pretrain", choices=("pretrain", "finetune"),
                   help="the JAX driver that wrote the directory (its optimizer chain)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from zs_aac_tpu_torch.utils.checkpoints import save_train_state
    from zs_aac_tpu_torch.utils.config import load_config

    payload = convert_jax_state(args.orbax_dir, load_config(args.config), args.driver)
    save_train_state(args.out, types.SimpleNamespace(**payload))
    print(f"wrote {args.out} (step {payload['step']})")
    return args.out


if __name__ == "__main__":
    main()
