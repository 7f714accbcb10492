"""The multi-process dryrun: every multi-GPU path of the port, held to one
process.

The counterpart of the JAX package's ``dryrun_multichip``: ``spawn`` starts
``nproc`` processes (gloo on the CPU, NCCL on cards, one card a process),
and each runs, at that function's tiny shapes:

1. the data-parallel ASE contrastive step (Cnn14 (8, 16) + BERT tiny, spec
   augmentation and dropout on, B = 2 * nproc) over a ``nproc`` x 1 mesh;
2. the dp x tp captioner step (GPT-2 TP-sharded, the mapper replicated,
   B = 2 * dp; tp = 2 for an even ``nproc``), two steps;
3. the dp x tp Mistral + LoRA step (the mapper and LoRA train), two steps;
4. the TP-sharded GPT-2 greedy decode, each ``data`` rank its rows.

The parent then runs the same four on the same global batches in one
process, and holds each to it: losses within 1e-5 relative, parameters
within 1e-5 absolute, batch statistics within 1e-5 of each leaf's size,
tokens and lengths equal. The steps update with
SGD (optax's, momentum 0.9) where the JAX dryrun uses AdamW, so that the
parameters show each gradient at its scale: Adam divides a gradient by
its own magnitude, which hides a gradient that is the world size times too
large, and it turns the rounding noise of a gradient that is exactly zero
(an attention key bias) into a step of the learning rate. It prints one
summary line.

Run: ``python -m zs_aac_tpu_torch.parallel.dryrun --nproc 4 --device cpu``.
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
from typing import Optional

import numpy as np
import torch

__all__ = ["spawn", "ase_run", "caption_run", "mistral_run", "decode_run", "run_dryrun",
           "main"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, nproc, port, out_dir, args, device, threads):
    from zs_aac_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    try:
        result = fn(init_distributed(device), *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        destroy_distributed()


def spawn(fn, nproc: int, *args, device="cpu", threads: int = 1) -> list:
    """Run ``fn(device, *args)`` in ``nproc`` fresh processes joined in one
    process group (``parallel.mesh.init_distributed``); returns each rank's
    result (``torch.save``-able), in rank order. ``fn`` must be importable
    (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_entry, args=(fn, nproc, _free_port(), out_dir, args, device,
                                         threads), nprocs=nproc, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(nproc)]


def _np_tree(tree, prefix=""):
    """A flat {path: numpy array} of a tree of tensors (modules by name)."""
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree

    tree = tensor_tree(tree)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_np_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().float().cpu().numpy().copy()
    return out


def _moved(params: dict, init: dict) -> float:
    """The largest change of a parameter over the run."""
    return max(float(np.abs(params[k] - init[k]).max()) for k in init if init[k].size)


def _mesh(dp: int, tp: int, distributed: bool):
    from zs_aac_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp, tp) if distributed else None


def _shard(batch: dict, mesh, dev) -> dict:
    from zs_aac_tpu_torch.parallel.mesh import shard_batch

    return {k: torch.as_tensor(v).to(dev) for k, v in shard_batch(batch, mesh).items()}


def ase_run(dev, world: int, distributed: bool = True) -> dict:
    """One data-parallel ASE step over a ``world`` x 1 mesh (no mesh when
    not ``distributed``) on the global batch of 2 * ``world`` rows."""
    from zs_aac_tpu_torch.models.ase import ASE, ASEConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.optim import cosine_lr, get_optimizer

    mesh = _mesh(world, 1, distributed)
    ase = ASE(ASEConfig(embed_size=32, audio_channels=(8, 16), text_model="prajjwal1/bert-tiny",
                        spec_augmentation=True))
    opt = get_optimizer(cosine_lr(0.1, 0, 50), "sgd")
    state = create_ase_state(0, ase, opt, device=dev)
    B = 2 * world
    rng = np.random.default_rng(0)
    batch = {"wave": rng.standard_normal((B, 16000)).astype(np.float32) * 0.1,
             "input_ids": rng.integers(0, 1000, (B, 12)),
             "attention_mask": np.ones((B, 12), np.int64),
             "idx": np.repeat(np.arange(B // 2), 2)}
    step = make_ase_train_step(ase, opt, device=dev, mesh=mesh)
    init = _np_tree(state.params)
    state, loss = step(state, _shard(batch, mesh, dev), 1)
    params = _np_tree(state.params)
    return {"loss": float(loss), "params": params, "moved": _moved(params, init),
            "batch_stats": _np_tree(state.batch_stats)}


def _caption_cfg():
    from zs_aac_tpu_torch.models.caption import CaptionConfig
    from zs_aac_tpu_torch.models.gpt2 import GPT2Config

    return CaptionConfig(prefix_length=4, prefix_size=16, clip_length=4,
                         gpt2=GPT2Config(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                                         n_head=4))


def _caption_batch(B: int, P: int, seed: int) -> dict:
    S, H = 8, 5
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, 250, (B, S)),
            "mask": np.ones((B, P + S), np.float32),
            "prefix": rng.standard_normal((B, 16)).astype(np.float32),
            "hard_prompt": rng.integers(1, 250, (B, H)),
            "hard_mask": np.ones((B, H), np.float32)}


def caption_run(dev, dp: int, tp: int, distributed: bool = True) -> dict:
    """Two dp x tp captioner steps (GPT-2 sharded over ``model``); the
    parameters returned whole."""
    from zs_aac_tpu_torch.parallel.tp import shard_gpt2_params, unshard_gpt2_params
    from zs_aac_tpu_torch.train.caption_trainer import (create_caption_state,
                                                        make_caption_train_step, tensor_tree)
    from zs_aac_tpu_torch.train.optim import get_optimizer

    mesh = _mesh(dp, tp, distributed)
    cfg = _caption_cfg()
    opt = get_optimizer(lambda step: 0.05, "sgd")
    state = create_caption_state(2, cfg, opt, device=dev)
    init = _np_tree(state.params)
    if mesh is not None:
        state.params["gpt2"] = shard_gpt2_params(state.params["gpt2"], cfg.gpt2, mesh)
        state.opt_state = opt.init(tensor_tree(state.params))
    step = make_caption_train_step(cfg, opt, device=dev, mesh=mesh)
    losses = []
    for i in range(2):
        batch = _shard(_caption_batch(2 * dp, cfg.prefix_length, 10 + i), mesh, dev)
        state, loss = step(state, batch, 3)
        losses.append(float(loss))
    params = dict(state.params)
    if mesh is not None:
        params["gpt2"] = unshard_gpt2_params(params["gpt2"], cfg.gpt2, mesh)
    params = _np_tree(params)
    return {"losses": losses, "params": params, "moved": _moved(params, init)}


def _mistral_cfg():
    from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig
    from zs_aac_tpu_torch.models.mistral import MistralConfig

    return MistralCaptionConfig(
        prefix_length=3, prefix_size=16, clip_length=3, islang=1, lora_r=2, lora_alpha=4,
        mistral=MistralConfig(vocab_size=256, hidden_size=64, n_layers=2, n_heads=4,
                              n_kv_heads=2, intermediate_size=128, sliding_window=64,
                              max_positions=64))


def mistral_run(dev, dp: int, tp: int, distributed: bool = True) -> dict:
    """Two dp x tp Mistral + LoRA steps (fp32 base and LoRA sharded over
    ``model``); the mapper and LoRA returned whole."""
    from zs_aac_tpu_torch.models.caption_mistral import init_mistral_caption
    from zs_aac_tpu_torch.models.mistral import init_mistral
    from zs_aac_tpu_torch.parallel.tp import (shard_mistral_lora, shard_mistral_params,
                                              unshard_mistral_lora)
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.train.optim import get_optimizer, multi_transform, set_to_zero
    from zs_aac_tpu_torch.train.train_prompt_multilingual import (
        MultilingualTrainState, make_multilingual_train_step, multilingual_labels)

    mesh = _mesh(dp, tp, distributed)
    cfg = _mistral_cfg()
    params = init_mistral_caption(cfg, 4, dev, init_mistral(cfg.mistral, 5, dev, torch.float32))
    # b = 0 at init would leave a without a gradient at the first step
    g = torch.Generator(device=dev).manual_seed(6)
    for site in [s for layer in params["lora"]["layers"] for s in layer.values()] + [
            params["lora"]["lm_head"]]:
        site["b"] = torch.randn(site["b"].shape, generator=g, device=dev) * 0.01
    init = _np_tree({"mapper": params["mapper"], "lora": params["lora"]})
    if mesh is not None:
        params["mistral"] = shard_mistral_params(params["mistral"], cfg.mistral, mesh)
        params["lora"] = shard_mistral_lora(params["lora"], cfg.mistral, mesh)
    opt = multi_transform({"trainable": get_optimizer(lambda step: 0.05, "sgd"),
                           "frozen": set_to_zero()}, multilingual_labels)
    state = MultilingualTrainState(params, opt.init(tensor_tree(params)), 0)
    step = make_multilingual_train_step(cfg, opt, 0.016, device=dev, mesh=mesh)
    losses = []
    for i in range(2):
        batch = _shard(_caption_batch(2 * dp, cfg.prefix_length, 20 + i), mesh, dev)
        state, loss = step(state, batch, 5)
        losses.append(float(loss))
    lora = state.params["lora"]
    if mesh is not None:
        lora = unshard_mistral_lora(lora, cfg.mistral, mesh)
    trained = _np_tree({"mapper": state.params["mapper"], "lora": lora})
    return {"losses": losses, "params": trained, "moved": _moved(trained, init)}


def decode_run(dev, dp: int, tp: int, distributed: bool = True) -> dict:
    """TP-sharded GPT-2 greedy decode of 2 * ``dp`` prefixes, each ``data``
    rank its rows, the tokens gathered."""
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode
    from zs_aac_tpu_torch.models.gpt2 import init_gpt2
    from zs_aac_tpu_torch.parallel.mesh import gather_rows, mesh_axis
    from zs_aac_tpu_torch.parallel.tp import shard_gpt2_params

    mesh = _mesh(dp, tp, distributed)
    cfg = _caption_cfg().gpt2
    params = init_gpt2(cfg, 6, dev)
    rng = np.random.default_rng(1)
    prefix = {"emb": rng.standard_normal((2 * dp, 4, cfg.n_embd)).astype(np.float32) * 0.1}
    emb = _shard(prefix, mesh, dev)["emb"]
    tp_axis = mesh_axis(mesh, "model")
    if mesh is not None:
        params = shard_gpt2_params(params, cfg, mesh)
    tokens, lengths = greedy_decode(params, cfg, emb, entry_length=12, tp=tp_axis)
    data = mesh_axis(mesh, "data")
    return {"tokens": gather_rows(tokens, data).cpu().numpy(),
            "lengths": gather_rows(lengths, data).cpu().numpy()}


def _all_runs(dev, nproc: int, distributed: bool = True) -> dict:
    tp = 2 if nproc % 2 == 0 else 1
    dp = nproc // tp
    return {"ase": ase_run(dev, nproc, distributed),
            "caption": caption_run(dev, dp, tp, distributed),
            "mistral": mistral_run(dev, dp, tp, distributed),
            "decode": decode_run(dev, dp, tp, distributed), "dp": dp, "tp": tp}


def _param_err(got: dict, want: dict, relative: bool = False) -> float:
    if sorted(got) != sorted(want):
        raise AssertionError(f"parameter trees differ: {sorted(set(got) ^ set(want))[:4]}")
    errs = []
    for k in want:
        scale = np.abs(want[k]).max() + 1e-12 if relative else 1.0
        errs.append(float(np.abs(got[k] - want[k]).max()) / scale if want[k].size else 0.0)
    return max(errs)


def run_dryrun(nproc: int = 4, device="cpu", threads: int = 1) -> dict:
    """Spawn the four runs on ``nproc`` processes and the one-process runs
    here; returns {"multi", "single", "errors"} (errors: the largest
    deviations, each beside its bound)."""
    from zs_aac_tpu_torch.utils.device import resolve_device

    multi = spawn(_all_runs, nproc, nproc, device=device, threads=threads)
    single = _all_runs(resolve_device(device), nproc, distributed=False)
    m = multi[0]
    for other in multi[1:]:     # every rank ends with the same result
        for run in ("caption", "mistral"):
            if _param_err(other[run]["params"], m[run]["params"]) != 0.0:
                raise AssertionError(f"{run}: ranks disagree")
    errors = {
        "ase_loss": (abs(m["ase"]["loss"] - single["ase"]["loss"])
                     / abs(single["ase"]["loss"]), 1e-5),
        "ase_params": (_param_err(m["ase"]["params"], single["ase"]["params"]), 1e-5),
        "ase_batch_stats": (_param_err(m["ase"]["batch_stats"], single["ase"]["batch_stats"],
                                       True), 1e-5),
    }
    for run in ("caption", "mistral"):
        errors[f"{run}_loss"] = (max(abs(a - b) / abs(b) for a, b in
                                     zip(m[run]["losses"], single[run]["losses"])), 1e-5)
        errors[f"{run}_params"] = (_param_err(m[run]["params"], single[run]["params"]), 1e-5)
    same = all(np.array_equal(m["decode"][k], single["decode"][k]) for k in ("tokens", "lengths"))
    errors["decode_tokens"] = (0.0 if same else 1.0, 0.0)
    return {"multi": m, "single": single, "errors": errors}


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", default="cpu", help="cpu (gloo) or cuda (NCCL, a card a rank)")
    p.add_argument("--threads", type=int, default=1, help="torch threads per process")
    args = p.parse_args(argv)
    out = run_dryrun(args.nproc, args.device, args.threads)
    bad = {k: v for k, v in out["errors"].items() if not v[0] <= v[1]}
    m = out["multi"]
    if bad:
        raise SystemExit(f"dryrun: multi-process results off the one-process ones: {bad}")
    print(f"dryrun OK on {args.nproc} {args.device} processes: ase dp{args.nproc} "
          f"loss={m['ase']['loss']:.4f}; caption dp{m['dp']}xtp{m['tp']} "
          f"loss={m['caption']['losses'][-1]:.4f}; mistral+lora dp{m['dp']}xtp{m['tp']} "
          f"loss={m['mistral']['losses'][-1]:.4f}; gpt2 tp{m['tp']} greedy decode parity ok "
          f"({int(m['decode']['lengths'].sum())} tokens); largest deviations "
          + ", ".join(f"{k} {v[0]:.2e} (<= {v[1]:g})" for k, v in out["errors"].items()),
          flush=True)
    return out


if __name__ == "__main__":
    main()
