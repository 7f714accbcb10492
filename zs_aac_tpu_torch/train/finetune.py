"""Retrieval finetuning driver (CLI).

The counterpart of the JAX package's ``train/finetune.py`` (the reference
``retrieval/train.py``): the pretraining loop run on one caption dataset
(AudioCaps or Clotho), warm-started from a pretraining checkpoint through
``restore_model_only`` (params and batch statistics; a fresh optimizer), with
per-epoch validation and ``best_model.ckpt`` on the best recall sum. The
model is built as the pretraining driver builds it (the train kernels on a
CUDA device). Under ``torchrun`` it is data-parallel as the pretraining
driver is: rank 0's state broadcast, each rank's rows of every global batch,
``validate`` on every rank, checkpoints and logs from rank 0 only. As
there, clips longer than ``max_length`` are cropped in each rank's load
order, so only a run with no cropped clip matches one process exactly.

Run: ``python -m zs_aac_tpu_torch.train.finetune -c configs/train.yaml -d
Clotho --pretrain_path outputs/.../best_model.ckpt --device cuda`` (``-c``
is read by ``utils.config.load_config``; ``run(config, dataset)`` takes the
config as a dict); on N cards ``torchrun --nproc_per_node N -m
zs_aac_tpu_torch.train.finetune ...``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from zs_aac_tpu_torch.train.pretrain import build_ase_from_config, validate

__all__ = ["main", "run"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-d", "--dataset", default="Clotho")
    p.add_argument("-l", "--lr", type=float, default=None)
    p.add_argument("--pretrain_path", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=None)
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
    if args.epochs:
        config["training"]["epochs"] = args.epochs
    from zs_aac_tpu_torch.parallel.mesh import destroy_distributed

    try:
        return run(config, args.dataset, device=args.device, pretrain_path=args.pretrain_path,
                   max_steps=args.max_steps, max_val_batches=args.max_val_batches)
    finally:
        destroy_distributed()


def run(config: dict, dataset: str = "Clotho", *, device="cuda", pretrain_path=None,
        max_steps=None, max_val_batches=None) -> str:
    """The finetuning loop on a config dict; returns the checkpoint dir."""
    from zs_aac_tpu_torch.parallel.mesh import (init_distributed, is_main_process,
                                                make_mesh_for_batch, process_index, replicate)

    dev = init_distributed(device)
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.data.prefetch import prefetch
    from zs_aac_tpu_torch.data.retrieval_data import AudioCaptionDataModule
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import (create_ase_state, make_ase_train_step,
                                                    make_encode_fns)
    from zs_aac_tpu_torch.train.optim import cosine_lr, get_optimizer
    from zs_aac_tpu_torch.utils.checkpoints import restore_model_only, save_train_state
    from zs_aac_tpu_torch.utils.logging_utils import (AverageMeter, log_results, rank_logger,
                                                      setup_seed)

    seed = config.get("seed", 20)
    setup_seed(seed + process_index())
    exp_dir = f"finetune_{dataset}_lr_{config['optim_args']['lr']}_seed_{seed}"
    logger = rank_logger(exp_dir, config.get("output_dir", "outputs"))

    tokenizer = WordPieceTokenizer.from_file(config["text_encoder_args"]["vocab"])
    ase, _ = build_ase_from_config(config, device=dev)
    mel_cfg = LogMelConfig.from_dict(config["audio_args"])
    dm = AudioCaptionDataModule(config, dataset, tokenizer, config.get("data_root", "data"))

    steps_per_epoch = max(len(dm.train_set) // dm.batch_size, 1)
    epochs = config["training"]["epochs"]
    schedule = cosine_lr(config["optim_args"]["lr"],
                         config["training"].get("warmup_epochs", 2) * steps_per_epoch,
                         epochs * steps_per_epoch)
    optimizer = get_optimizer(schedule, config["optim_args"].get("optimizer_name", "adamw"))
    state = create_ase_state(seed, ase, optimizer, device=dev)
    pretrain_path = pretrain_path or config.get("pretrain_path")
    if pretrain_path:
        state = restore_model_only(pretrain_path, state)
        logger.info("warm start from %s", pretrain_path)

    replicate(state)
    train_step = make_ase_train_step(ase, optimizer, mel_cfg, device=dev,
                                     mesh=make_mesh_for_batch(dm.batch_size))
    encode_audio, encode_text = make_encode_fns(ase, mel_cfg, device=dev)
    ckpt_dir = os.path.join(config.get("output_dir", "outputs"), exp_dir, "models")
    os.makedirs(ckpt_dir, exist_ok=True)
    best_recall = -1.0
    it = 0
    for epoch in range(epochs):
        t0 = time.time()
        meter = AverageMeter()
        losses = []
        for batch in prefetch(dm.train_batches(seed + epoch)):
            batch = {k: v for k, v in batch.items() if k != "text"}
            state, loss = train_step(state, batch, seed + 1)
            losses.append(loss)
            it += 1
            if max_steps and it >= max_steps:
                break
        for v in (torch.stack(losses).float().cpu().tolist() if losses else []):
            meter.update(v)
        logger.info("epoch %d: loss %.4f, %.1fs", epoch, meter.avg, time.time() - t0)
        variables = {"params": state.params, "batch_stats": state.batch_stats}
        m_t2a, m_a2t = validate(encode_audio, encode_text, variables,
                                dm.val_batches(max_val_batches))
        log_results(logger, m_t2a, dataset, "t2a", epoch)
        log_results(logger, m_a2t, dataset, "a2t", epoch)
        rsum = m_t2a["r1"] + m_t2a["r5"] + m_t2a["r10"]
        if rsum > best_recall:
            best_recall = rsum
            if is_main_process():
                save_train_state(os.path.join(ckpt_dir, "best_model.ckpt"), state)
        if max_steps and it >= max_steps:
            break
    print(f"done: {ckpt_dir}", flush=True)
    return ckpt_dir


if __name__ == "__main__":
    main()
