"""Captioner training driver (CLI).

The port of the JAX package's ``train/train_prompt.py``, with its flag
surface and run dir contract: a timestamped dir (``%b-%d-%H-%M-%S`` under
``--out_dir``) with ``params.json`` (the flags plus ``gpt2_vocab_size``) and
``train_caption.log``; CIDEr validation every ``--val_interval`` steps with a
beam-3 decode (``run_validation``); ``best.pth`` on each CIDEr improvement
and after a final validation, ``last.pth`` each epoch. Snapshots are the JAX
package's msgpack layout (``utils/checkpoints.py::save_params``), so either
package's ``predict_prompt`` reads the run dir; ``--ckpt_file`` takes either
package's snapshot. ``--max_iters`` caps the steps.

The train step is ``train/caption_trainer.py`` on ``--device`` (default
``cuda``; ``cpu`` runs on the CPU). ``--tokenizer`` takes GPT-2's BPE files
or a SentencePiece ``.model``. ``--data_parallel`` shards each batch over
the ranks that ``torchrun`` started (the most that divide ``--bs``; one
process without ``torchrun``): rank 0's parameters are broadcast, each rank
trains on its rows and the gradients are summed, so the run trains as one
process would on the same batches. Rank 0 names the run dir, writes the
snapshots and the log, and runs the validation.

Run: ``python -m zs_aac_tpu_torch.train.train_prompt --data bank.pkl
--valdata test.pkl ...``; on N cards ``torchrun --nproc_per_node N -m
zs_aac_tpu_torch.train.train_prompt --data_parallel ...``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["build_parser", "main", "run_validation"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # data
    p.add_argument("--data", nargs="+", type=str, required=True)
    p.add_argument("--valdata", type=str, required=True)
    p.add_argument("--out_dir", default="./checkpoints/run")
    p.add_argument("--sound_effect", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--prefix", default="coco_prefix")
    p.add_argument("--ckpt_file", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None,
                   help="dir with GPT-2 vocab.json/merges.txt, or a SentencePiece "
                        ".model; default: word-level tokenizer built from the "
                        "training bank")
    # training
    p.add_argument("--bs", type=int, default=40)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--val_interval", type=int, default=600)
    p.add_argument("--max_iters", type=int, default=None,
                   help="reproduce the reference's epochs*600 iteration cap")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batches over the ranks torchrun started (the "
                        "reference's DDP)")
    # model
    p.add_argument("--prefix_length", type=int, default=10)
    p.add_argument("--prefix_length_clip", type=int, default=10)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--sound_effect_num", type=int, default=0)
    p.add_argument("--noise_variance", type=float, default=0.0)
    p.add_argument("--mapping_type", type=str, default="mlp")
    p.add_argument("--is_rn", action="store_true")
    p.add_argument("--prefix_dim", type=int, default=None,
                   help="CLAP embedding dim; default 1024 with --is_rn else 512")
    p.add_argument("--only_prefix", action="store_true")
    p.add_argument("--only_soft_prompt", action="store_true")
    p.add_argument("--use_sound_effect", action="store_true")
    p.add_argument("--mask_probability", type=float, default=0.0)
    p.add_argument("--gpt2_size", choices=["tiny", "small", "base"], default="base",
                   help="GPT-2 size for random init (no pretrained weights "
                        "in an offline env); 'tiny' for smoke runs")
    # dataset
    p.add_argument("--percentage", type=float, default=1.0)
    p.add_argument("--normalize_prefix", action="store_true")
    p.add_argument("--use_audio_embedding", action="store_true")
    p.add_argument("--use_related_text", action="store_true")
    return p


def _gpt2_config(size: str, vocab_size: int):
    from zs_aac_tpu_torch.models.gpt2 import GPT2Config

    if size == "tiny":
        return GPT2Config(vocab_size=vocab_size, n_positions=128, n_embd=64,
                          n_layer=2, n_head=4)
    if size == "small":
        return GPT2Config(vocab_size=vocab_size, n_positions=512, n_embd=256,
                          n_layer=6, n_head=8)
    return GPT2Config(vocab_size=max(vocab_size, 50257))


def _make_tokenizer(tokenizer_path, records_paths):
    """(tokenizer, stop token id): a SentencePiece ``.model``, GPT-2's BPE
    files in ``tokenizer_path``, or a word tokenizer built from the banks'
    captions."""
    from zs_aac_tpu_torch.data.banks import iter_bank
    from zs_aac_tpu_torch.data.tokenizer import GPT2BPETokenizer, WordTokenizer

    if tokenizer_path:
        if tokenizer_path.endswith(".model"):
            from zs_aac_tpu_torch.data.sentencepiece import SentencePieceTokenizer

            sp = SentencePieceTokenizer.from_file(tokenizer_path)
            # captions end in "." and eos never appears in the training
            # targets, so the stop id is the "." piece; failing that, the
            # byte piece of ".", then eos
            stop = sp.piece_to_id.get(".")
            if stop is None:
                stop = sp.byte_pieces.get(ord("."), sp.eos_id)
            return sp, stop
        tok = GPT2BPETokenizer.from_dir(tokenizer_path)
        return tok, tok.encode(".")[0]
    corpus = []
    for path in records_paths:
        for rec in iter_bank(path):
            cap = rec.get("caption")
            if isinstance(cap, list):
                corpus.extend(str(c["caption"]) for c in cap)
            elif cap:
                corpus.append(str(cap))
    corpus.append("there are something in this audio.")
    tok = WordTokenizer.from_corpus(corpus)
    return tok, tok.stop_token_id


def _mean_loss(losses):
    """One device fetch for the losses since the last log line."""
    if not losses:
        return 0.0
    return float(torch.stack(losses).mean())


@torch.no_grad()
def run_validation(params, ccfg, val_ds, tokenizer, stop_id, key2refs, beam_size=3,
                   device="cuda"):
    """Beam-decode the validation set (clips grouped by hard-prompt length,
    chunks of 32, the last padded) and score CIDEr: (score, key2pred)."""
    from zs_aac_tpu_torch.decoding.beam import beam_search_batched
    from zs_aac_tpu_torch.eval.captioning import eval_prediction
    from zs_aac_tpu_torch.models.caption import caption_embeddings
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    groups = defaultdict(list)
    for i in range(len(val_ds)):
        item = val_ds[i]
        groups[len(item.get("hard_prompt", ()))].append(item)

    key2pred = {}
    CHUNK = 32
    for h, items in groups.items():
        for s in range(0, len(items), CHUNK):
            chunk = items[s:s + CHUNK]
            padded = chunk + [chunk[-1]] * (CHUNK - len(chunk))
            prefix = torch.from_numpy(np.stack([it["prefix"] for it in padded])).to(dev)
            hp = (torch.from_numpy(np.stack([it["hard_prompt"] for it in padded])).to(dev)
                  if h else None)
            emb = caption_embeddings(params, ccfg, prefix, hp)
            toks, lens, scores = beam_search_batched(params["gpt2"], ccfg.gpt2, emb,
                                                     beam_size, 67, stop_id, 1.0)
            best = scores.argmax(dim=1).cpu().numpy()   # the first of equal scores
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            for b, it in enumerate(chunk):
                ids = list(toks[b, best[b]][: int(lens[b, best[b]])])
                key2pred[it["audio_id"]] = [tokenizer.decode(ids).lower()]
    out = eval_prediction(key2refs, key2pred, metrics=("CIDEr",))
    return out["CIDEr"], key2pred


def _load_ckpt(params, path, device):
    """``params`` with their values from a ``best.pth``/``last.pth`` snapshot
    of either package; the trees must hold the same leaves and shapes (as
    flax's restore demands)."""
    from zs_aac_tpu_torch.models.convert import from_jax_params
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    loaded = from_jax_params(load_params(path), device=device)
    want = {k: tuple(v.shape) for k, v in _flat(tensor_tree(params)).items()}
    got = {k: tuple(v.shape) for k, v in _flat(tensor_tree(loaded)).items()}
    if want != got:
        raise ValueError(f"{path} does not hold this model's parameters: "
                         f"{sorted(set(want.items()) ^ set(got.items()))[:6]}")
    return loaded


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)

    from zs_aac_tpu_torch.data.datasets import (CaptionBankDataset, CaptionBankTestDataset,
                                                CaptionDatasetConfig, caption_batches)
    from zs_aac_tpu_torch.data.prefetch import prefetch
    from zs_aac_tpu_torch.models.caption import CaptionConfig
    from zs_aac_tpu_torch.train.caption_trainer import (create_caption_state,
                                                        make_caption_optimizer,
                                                        make_caption_train_step, tensor_tree)
    from zs_aac_tpu_torch.train.optim import linear_warmup_lr
    from zs_aac_tpu_torch.parallel.mesh import (broadcast_object, destroy_distributed,
                                                init_distributed, is_main_process,
                                                make_mesh_for_batch, replicate, shard_batch)
    from zs_aac_tpu_torch.utils.checkpoints import (criterion_improver, join_async_saves,
                                                    save_params_async)

    device = init_distributed(args.device)
    main_proc = is_main_process()
    np.random.seed(args.seed)

    tokenizer, stop_id = _make_tokenizer(args.tokenizer, args.data)

    dcfg = CaptionDatasetConfig(
        prefix_length=args.prefix_length,
        normalize_prefix=args.normalize_prefix,
        use_audio_embedding=args.use_audio_embedding,
        use_related_text=args.use_related_text,
        percentage=args.percentage,
        sound_effect_path=args.sound_effect,
        sound_effect_k=3,
        mask_probability=args.mask_probability,
        seed=args.seed,
    )
    dataset = CaptionBankDataset(args.data, tokenizer, dcfg)
    val_ds = CaptionBankTestDataset(args.valdata, tokenizer, dcfg)
    key2refs = val_ds.references()

    prefix_dim = args.prefix_dim or (1024 if args.is_rn else 512)
    ccfg = CaptionConfig(
        prefix_length=args.prefix_length,
        prefix_size=prefix_dim,
        clip_length=args.prefix_length_clip,
        num_layers=args.num_layers,
        mapping_type=args.mapping_type,
        only_prefix=args.only_prefix,
        only_soft_prompt=args.only_soft_prompt,
        sound_effect_num=args.sound_effect_num,
        gpt2=_gpt2_config(args.gpt2_size, tokenizer.vocab_size),
    )

    out_dir = broadcast_object(
        os.path.join(args.out_dir, time.strftime("%b-%d-%H-%M-%S", time.localtime())))
    args.output_dir = out_dir
    logger = logging.getLogger(f"train_caption.{out_dir}")
    logger.setLevel(logging.INFO)
    if main_proc:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "params.json"), "w") as f:
            json.dump({**vars(args), "gpt2_vocab_size": ccfg.gpt2.vocab_size}, f)
        handler = logging.FileHandler(os.path.join(out_dir, "train_caption.log"))
    else:
        handler = logging.NullHandler()
    logger.addHandler(handler)
    try:
        logger.info("Args: %s", vars(args))

        steps_per_epoch = max(len(dataset) // args.bs, 1)
        schedule = linear_warmup_lr(args.lr, args.warmup * steps_per_epoch,
                                    args.epochs * steps_per_epoch)
        optimizer = make_caption_optimizer(ccfg, schedule, args.weight_decay)
        state = create_caption_state(args.seed, ccfg, optimizer, device=device)
        if args.ckpt_file:
            state.params = _load_ckpt(state.params, args.ckpt_file, device)
            state.opt_state = optimizer.init(tensor_tree(state.params))
        mesh = make_mesh_for_batch(args.bs) if args.data_parallel else None
        replicate(state.params)
        step_fn = make_caption_train_step(ccfg, optimizer, args.noise_variance, device=device,
                                          mesh=mesh)

        improved = criterion_improver("score")
        logger.info("%10s\t%10s\t%10s", "Epoch", "Train loss", "Val score")

        def validate():
            return run_validation(state.params, ccfg, val_ds, tokenizer, stop_id, key2refs,
                                  device=device)[0]

        it = 0
        losses = []
        for epoch in range(args.epochs):
            print(f">>> Training epoch {epoch}", flush=True)
            losses = []
            for batch in prefetch(caption_batches(dataset, args.bs, shuffle=True,
                                                  seed=args.seed + epoch)):
                state, loss = step_fn(state, shard_batch(batch, mesh), args.seed + 1)
                losses.append(loss)
                it += 1
                if it % args.val_interval == 0 and main_proc:
                    score = validate()
                    logger.info("%10d\t%10.3g\t%10.3g", epoch, _mean_loss(losses), score)
                    if improved(score):
                        save_params_async(os.path.join(out_dir, "best.pth"), state.params)
                if args.max_iters and it >= args.max_iters:
                    break
            if main_proc:
                save_params_async(os.path.join(out_dir, "last.pth"), state.params)
            if args.max_iters and it >= args.max_iters:
                break

        # a final validation, so that short runs still write best.pth
        if main_proc:
            score = validate()
            logger.info("final\t%10.3g\t%10.3g", _mean_loss(losses), score)
            if improved(score):
                save_params_async(os.path.join(out_dir, "best.pth"), state.params)
            join_async_saves()
            print(f"run dir: {out_dir}  final CIDEr: {score:.4f}", flush=True)
    finally:
        logger.removeHandler(handler)
        handler.close()
        destroy_distributed()
    return out_dir


if __name__ == "__main__":
    main()
