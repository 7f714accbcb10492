"""CLAP contrastive pretraining driver (CLI).

The counterpart of the JAX package's ``train/pretrain.py`` (the reference
``retrieval/pretrain.py``): YAML config + CLI overrides, duration-bucketed
batches, per-step cosine LR with warmup, the ATC loss with multi-positive
targets, per-epoch validation recalls on the val caption sets,
``best_model.ckpt`` on the lowest epoch loss plus a best-by-recall-sum
checkpoint per val set, resume, and a final test-set evaluation of every
saved checkpoint. ``clip_grad`` is applied when set, as in the JAX package.
wandb logs whenever it imports, as in the JAX driver (``WANDB_MODE=disabled``
turns it off).

The audio tower is the config's: HTSAT (``type: transformer``), or Cnn14 or
ResNet38 (``type: cnn``, ``model``), whose convolutions are cuDNN's; every
tower's log-mel is kernel K2 on the card. The HTSAT tower trains through the
hand-written kernels: ``build_ase_from_config`` turns on ``fused_attn`` and
makes ``fused_block`` every stage but the last on a CUDA device (the extract
driver's dispatch): K7 forward and K8/K9 backward in stages 1-3, K5 forward
and K6 backward in stage 4. Checkpoints are the port's own
(``utils.checkpoints``).

Multi-GPU: under ``torchrun`` (``parallel.mesh.init_distributed``) the run
is data-parallel over all ranks: rank 0's initial state is broadcast, each
rank loads its ``local_batch_slice`` of every global batch (which must
divide by the world size), and the train step gathers embeddings and batch
statistics over ranks (``train/contrastive.py``). The step's draws take the
config's seed on every rank, since each rank draws for the global batch.
The random crops of clips longer than ``max_length`` take ``seed + rank``
(the JAX driver's ``process_index`` offset) in each rank's load order, so
the run trains as one process would on the same global batches only where
no clip is cropped; with cropped clips world N differs from world 1 in the
crops. Every rank runs ``validate``, which reassembles the ranks' rows
(``allgather_by_index``; ``--max_val_batches`` caps the global batches, so
every world size validates the same rows); only rank 0 writes checkpoints
and logs.

Run: ``python -m zs_aac_tpu_torch.train.pretrain -c configs/pretrain.yaml
--device cuda`` (``-c`` is read by ``utils.config.load_config``, the YAML
subset of the repo's configs, or JSON; ``run(config)`` takes the config as
a dict); on N cards ``torchrun --nproc_per_node N -m
zs_aac_tpu_torch.train.pretrain ...``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

__all__ = ["main", "run", "validate", "build_ase_from_config", "load_pretrained_encoder",
           "apply_freeze", "build_optimizer"]


def build_ase_from_config(config: dict, device="cuda"):
    """``(ASE, ASEConfig)`` from a pretrain/extract config (the JAX
    ``build_ase_from_config``). ``fused_attn`` defaults to True where
    ``device`` is a CUDA device, and ``fused_block`` then to every HTSAT
    stage but the last; the port also reads an optional ``htsat_kwargs``
    mapping of HTSAT geometry overrides. Each process drives one card, so
    the host's device count does not enter (the JAX package's single-device
    gate is about GSPMD, which has no counterpart here)."""
    from zs_aac_tpu_torch.models.ase import ASE, ASEConfig

    enc_args = config.get("audio_encoder_args", {})
    if enc_args.get("type", "cnn") == "transformer":
        encoder = "htsat"
    else:
        encoder = "cnn14" if enc_args.get("model", "Cnn14") == "Cnn14" else "resnet38"
    fused = config.get("fused_attn", torch.device(device).type == "cuda")
    htsat_kwargs = config.get("htsat_kwargs") or {}
    n_stages = len(htsat_kwargs.get("depths", (2, 2, 6, 2)))
    fused_block = config.get("fused_block", tuple(range(n_stages - 1)) if fused else False)
    if isinstance(fused_block, list):
        fused_block = tuple(fused_block)
    cfg = ASEConfig(
        embed_size=config.get("embed_size", 1024),
        temp=config.get("temp", 0.07),
        embed_regularization=config.get("embed_regularization", True),
        audio_encoder=encoder,
        text_model=config.get("text_encoder_args", {}).get("type", "bert-base-uncased"),
        spec_augmentation=config.get("training", {}).get("spec_augmentation", True),
        audio_channels=tuple(config["audio_channels"]) if config.get("audio_channels")
        else None,
        n_mels=config.get("audio_args", {}).get("n_mels", 64),
        htsat_kwargs=tuple((k, tuple(v) if isinstance(v, list) else v)
                           for k, v in htsat_kwargs.items()) if htsat_kwargs else None,
        fused_attn=fused,
        fused_block=fused_block,
        dtype=torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32,
    )
    return ASE(cfg), cfg


def load_pretrained_encoder(state, config, device="cuda"):
    """Load pretrained PANNs or HTSAT weights into the ASE audio tower (the
    reference's checkpoint surgery). ``audio_encoder_args.pretrained_path``
    is a torch state dict (or {"model": ...}/{"state_dict": ...}) or an
    ``.npz``: ``type: transformer`` an HTSAT checkpoint, else ``model``
    ResNet38 or Cnn14 (``len(audio_channels)`` blocks where the config sets
    them, else 6)."""
    enc = config.get("audio_encoder_args", {})
    path = enc.get("pretrained_path")
    if not (enc.get("pretrained") and path):
        return state
    from zs_aac_tpu_torch.models.convert import convert_cnn, convert_htsat, convert_resnet38

    if path.endswith(".npz"):
        sd = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        if enc.get("type") == "transformer":
            sd = {k.removeprefix("sed_model."): v for k, v in sd.items()
                  if "spectrogram_extractor" not in k and "logmel_extractor" not in k}
    sd = {k: v for k, v in sd.items() if "fc" not in k and not k.startswith(("spec", "logmel"))}
    if enc.get("type") == "transformer":
        conv = convert_htsat(sd, device=device)
    elif enc.get("model") == "ResNet38":
        conv = convert_resnet38(sd, device=device)
    else:
        channels = config.get("audio_channels")
        conv = convert_cnn(sd, n_blocks=len(channels) if channels else 6, device=device)
    state.params["audio_enc"] = _like(state.params["audio_enc"], conv["params"])
    state.batch_stats["audio_enc"] = _like(state.batch_stats["audio_enc"], conv["batch_stats"])
    return state


def _like(old, new):
    """``new``'s leaves where it has them (on ``old``'s device and dtype),
    ``old``'s elsewhere, in ``old``'s tree."""
    if isinstance(old, dict):
        return {k: _like(old[k], new[k]) if k in new else old[k] for k in old}
    return new.to(old.device, old.dtype)


def apply_freeze(optimizer, config):
    """Zero updates for frozen towers (``audio_encoder_args.freeze`` /
    ``text_encoder_args.freeze``): the optimizer runs on the trainable keys
    only, so a clip in it sees only those."""
    freeze_audio = config.get("audio_encoder_args", {}).get("freeze", False)
    freeze_text = config.get("text_encoder_args", {}).get("freeze", False)
    if not (freeze_audio or freeze_text):
        return optimizer
    from zs_aac_tpu_torch.train.optim import multi_transform, set_to_zero

    def label(params):
        return {k: "frozen" if (k == "audio_enc" and freeze_audio)
                or (k == "text_enc" and freeze_text) else "trainable" for k in params}

    return multi_transform({"trainable": optimizer, "frozen": set_to_zero()}, label)


def build_optimizer(config, steps_per_epoch: int):
    """The config's schedule and optimizer, with ``clip_grad`` and the
    freezes (the JAX driver's chain)."""
    from zs_aac_tpu_torch.train.optim import (chain, clip_by_global_norm, cosine_lr,
                                              get_optimizer, step_lr)

    optim = config["optim_args"]
    lr = optim["lr"]
    epochs = config["training"]["epochs"]
    warmup = config["training"].get("warmup_epochs", 2) * steps_per_epoch
    if optim.get("scheduler", "cosine") == "cosine":
        schedule = cosine_lr(lr, warmup, epochs * steps_per_epoch)
    else:
        schedule = step_lr(lr, warmup, steps_per_epoch * 10, 0.1)
    optimizer = get_optimizer(schedule, optim.get("optimizer_name", "adamw"),
                              tuple(optim.get("betas", (0.9, 0.999))), optim.get("eps", 1e-8),
                              optim.get("momentum", 0.9), optim.get("weight_decay", 0.0))
    clip = config["training"].get("clip_grad")
    if clip:
        optimizer = chain(clip_by_global_norm(float(clip)), optimizer)
    return apply_freeze(optimizer, config)


def validate(encode_audio, encode_text, variables, batches):
    """Encode a val/test set and compute the t2a/a2t recalls. Batches that
    carry global row ids (``"index"``: the data module's, strided over
    ranks) are reassembled in that order on every rank
    (``allgather_by_index``), so every rank must call it; without ids the
    rows keep the batches' order. A capped evaluation is capped at the
    source (the data module's ``max_batches``), before the striding."""
    from zs_aac_tpu_torch.eval.retrieval import a2t, t2a
    from zs_aac_tpu_torch.parallel.mesh import allgather_by_index

    audio_embs, text_embs, indices = [], [], []
    row = 0
    for batch in batches:
        audio_embs.append(encode_audio(variables, batch["wave"]).float().cpu().numpy())
        text_embs.append(encode_text(variables, batch["input_ids"],
                                     batch["attention_mask"]).float().cpu().numpy())
        n = len(audio_embs[-1])
        indices.append(np.asarray(batch["index"], np.int64) if "index" in batch
                       else np.arange(row, row + n, dtype=np.int64))
        row += n
    audio, text = allgather_by_index(np.concatenate(indices), np.concatenate(audio_embs),
                                     np.concatenate(text_embs))
    n = (audio.shape[0] // 5) * 5
    if n == 0:
        zero = {k: 0.0 for k in ("r1", "r5", "r10", "r50", "medr", "meanr", "mAP10")}
        return dict(zero), dict(zero)
    return t2a(audio[:n], text[:n]), a2t(audio[:n], text[:n])


def run(config: dict, *, device="cuda", resume_ckpt=None, max_steps=None,
        max_val_batches=None) -> str:
    """The pretraining loop on a config dict; returns the checkpoint dir."""
    from zs_aac_tpu_torch.parallel.mesh import (barrier, init_distributed, is_main_process,
                                                make_mesh_for_batch, process_index, replicate)

    dev = init_distributed(device)
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.data.prefetch import prefetch
    from zs_aac_tpu_torch.data.retrieval_data import (AudioCaptionDataModule,
                                                      AudioLanguagePretrainDataset,
                                                      pretrain_batches)
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import (create_ase_state, make_ase_train_step,
                                                    make_encode_fns)
    from zs_aac_tpu_torch.utils.checkpoints import restore_train_state, save_train_state
    from zs_aac_tpu_torch.utils.logging_utils import (AverageMeter, log_results, maybe_wandb,
                                                      rank_logger, setup_seed)
    from zs_aac_tpu_torch.utils.preemption import PreemptionGuard

    guard = PreemptionGuard()
    main = is_main_process()
    seed = config.get("seed", 20)
    setup_seed(seed + process_index())
    exp_name = config.get("exp_name", "pretrain")
    model_name = config["audio_encoder_args"].get("model", "Cnn14")
    lr = config["optim_args"]["lr"]
    exp_dir = f"{exp_name}_{model_name}_lr_{lr}_seed_{seed}"
    logger = rank_logger(exp_dir, config.get("output_dir", "outputs"))
    wandb = maybe_wandb() if main else None
    wandb_run = wandb.init(project=exp_name, config=config) if wandb else None

    tokenizer = WordPieceTokenizer.from_file(config["text_encoder_args"]["vocab"])
    ase, _ = build_ase_from_config(config, device=dev)
    mel_cfg = LogMelConfig.from_dict(config["audio_args"])
    dataset = AudioLanguagePretrainDataset(config["json_files"], config["audio_args"],
                                           config.get("blacklist"), seed + process_index())
    batch_size = config["data_args"]["batch_size"]
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    epochs = config["training"]["epochs"]
    optimizer = build_optimizer(config, steps_per_epoch)
    state = create_ase_state(seed, ase, optimizer, device=dev)
    state = load_pretrained_encoder(state, config, dev)
    start_epoch = 0
    ckpt_dir = os.path.join(config.get("output_dir", "outputs"), exp_dir, "models")
    os.makedirs(ckpt_dir, exist_ok=True)
    if config.get("resume") and resume_ckpt:
        state = restore_train_state(resume_ckpt, state)
        start_epoch = state.step // steps_per_epoch
    replicate(state)

    train_step = make_ase_train_step(ase, optimizer, mel_cfg, device=dev,
                                     mesh=make_mesh_for_batch(batch_size))
    encode_audio, encode_text = make_encode_fns(ase, mel_cfg, device=dev)
    val_modules = {name: AudioCaptionDataModule(config, name, tokenizer,
                                                config.get("data_root", "data"))
                   for name in config.get("val_datasets", [])}

    best_loss = float("inf")
    best_recall = {k: -1.0 for k in val_modules}
    it = 0
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        meter = AverageMeter()
        losses = []
        for batch in prefetch(pretrain_batches(dataset, tokenizer, batch_size,
                                               seed=seed + epoch)):
            batch = {k: v for k, v in batch.items() if k != "text"}
            state, loss = train_step(state, batch, seed + 1)
            losses.append(loss)
            it += 1
            if guard.should_stop:
                if main:
                    save_train_state(os.path.join(ckpt_dir, "preempt_model.ckpt"), state)
                logger.info("preempted at step %d; checkpoint saved", it)
                guard.exit_gracefully()
            if max_steps and it >= max_steps:
                break
        for v in (torch.stack(losses).float().cpu().tolist() if losses else []):
            meter.update(v)
        logger.info("epoch %d: loss %.4f, time %.1fs", epoch, meter.avg, time.time() - t0)
        if wandb_run:
            wandb_run.log({"loss": meter.avg, "epoch": epoch})
        if meter.avg < best_loss:
            best_loss = meter.avg
            if main:
                save_train_state(os.path.join(ckpt_dir, "best_model.ckpt"), state)
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        for ds_name, dm in val_modules.items():
            m_t2a, m_a2t = validate(encode_audio, encode_text, variables,
                                    dm.val_batches(max_val_batches))
            log_results(logger, m_t2a, ds_name, "t2a", epoch, wandb_run)
            log_results(logger, m_a2t, ds_name, "a2t", epoch, wandb_run)
            rsum = m_t2a["r1"] + m_t2a["r5"] + m_t2a["r10"]
            if rsum > best_recall[ds_name] and main:
                save_train_state(os.path.join(ckpt_dir, f"{ds_name}_best_model.ckpt"), state)
            best_recall[ds_name] = max(best_recall[ds_name], rsum)
        if max_steps and it >= max_steps:
            break

    # the test sets on every saved checkpoint (reference pretrain.py:232-255)
    barrier()
    for ckpt_name in ["best_model"] + [f"{ds}_best_model" for ds in val_modules]:
        path = os.path.join(ckpt_dir, f"{ckpt_name}.ckpt")
        if not os.path.exists(path):
            continue
        saved = restore_train_state(path, state)
        variables = {"params": saved.params, "batch_stats": saved.batch_stats}
        for ds_name, dm in val_modules.items():
            m_t2a, m_a2t = validate(encode_audio, encode_text, variables,
                                    dm.test_batches(max_val_batches))
            log_results(logger, m_t2a, f"{ds_name}-test[{ckpt_name}]", "t2a", epochs, wandb_run)
            log_results(logger, m_a2t, f"{ds_name}-test[{ckpt_name}]", "a2t", epochs, wandb_run)
    guard.restore()
    print(f"done: {ckpt_dir}", flush=True)
    return ckpt_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-l", "--lr", type=float, default=None)
    p.add_argument("-t", "--model_type", default=None)
    p.add_argument("-m", "--model", default=None)
    p.add_argument("-a", "--max_length", type=int, default=None)
    p.add_argument("-s", "--batch_size", type=int, default=None)
    p.add_argument("-b", "--blacklist", default=None)
    p.add_argument("-d", "--dataset", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume_ckpt", default=None)
    p.add_argument("--max_steps", type=int, default=None, help="debug cap")
    p.add_argument("--max_val_batches", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from zs_aac_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    from zs_aac_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    if args.lr:
        config["optim_args"]["lr"] = args.lr
    if args.model_type:
        config["audio_encoder_args"]["type"] = args.model_type
    if args.model:
        config["audio_encoder_args"]["model"] = args.model
    if args.max_length:
        config["audio_args"]["max_length"] = args.max_length
    if args.batch_size:
        config["data_args"]["batch_size"] = args.batch_size
    if args.blacklist:
        config["blacklist"] = args.blacklist
    if args.epochs:
        config["training"]["epochs"] = args.epochs
    if args.seed is not None:
        config["seed"] = args.seed
    from zs_aac_tpu_torch.parallel.mesh import destroy_distributed

    try:
        return run(config, device=args.device, resume_ckpt=args.resume_ckpt,
                   max_steps=args.max_steps, max_val_batches=args.max_val_batches)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
