"""Multilingual (Mistral + LoRA) captioner training driver (CLI).

The port of the JAX package's ``train/train_prompt_multilingual.py``, with
its flag surface and run dir contract: a timestamped dir (``%b-%d-%H-%M-%S``
under ``--out_dir``) with ``params.json`` (the flags plus ``islang`` and
``mistral_vocab_size``) and ``train_caption.log`` (epoch, mean loss, CIDEr);
captions tagged ``<en>``/``<zh>``/``<fr>``, whose tag tokens the
cross-entropy skips; a cosine schedule with warmup and AdamW on the mapper
and LoRA only (the base is frozen through ``multi_transform`` +
``set_to_zero``); after each epoch a batched greedy ``<en>`` decode (eos 2,
at most 60 tokens) scored with CIDEr; ``best.pth``/``last.pth`` hold
``{"mapper", "lora"}`` in the JAX package's msgpack layout, so either
package's ``predict_multilingual`` serves the run dir.

``--mistral_ckpt`` takes a JAX-written msgpack of the base, served in the
dtype it was stored in (as flax restores it). Without it the base is random
bf16 from the port's own generator, seeded by ``--seed``: it cannot equal the
JAX driver's ``jax.random`` draws. ``--tokenizer`` takes a SentencePiece
``.model`` (the Mistral tokenizer) or GPT-2's BPE files; without it a word
tokenizer is built from the banks and extended by the language tags.

The train step is ``make_multilingual_train_step`` on ``--device`` (default
``cuda``; ``cpu`` runs on the CPU).

Run: ``python -m zs_aac_tpu_torch.train.train_prompt_multilingual --data
bank.pkl --valdata test.pkl ...``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Any

import numpy as np
import torch

__all__ = ["build_parser", "main", "run_multilingual_validation", "LANG_TAGS",
           "MultilingualTrainState", "multilingual_labels", "make_multilingual_optimizer",
           "make_multilingual_train_step", "load_mistral_base", "extend_with_lang_tags"]

LANG_TAGS = {"en": "<en>", "zh": "<zh>", "fr": "<fr>"}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", nargs="+", required=True)
    p.add_argument("--valdata", required=True)
    p.add_argument("--out_dir", default="./checkpoints/multilingual")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--sound_effect", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="SentencePiece .model (the Mistral tokenizer) or a GPT-2 "
                        "BPE dir; default: a word tokenizer built from the banks")
    p.add_argument("--mistral_ckpt", default=None,
                   help="converted Mistral params (msgpack); random init if absent")
    p.add_argument("--mistral_size", choices=["tiny", "7b"], default="7b")
    p.add_argument("--bs", type=int, default=40)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--prefix_length", type=int, default=10)
    p.add_argument("--prefix_length_clip", type=int, default=10)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--noise_variance", type=float, default=0.0)
    p.add_argument("--mapping_type", default="mlp")
    p.add_argument("--is_rn", action="store_true")
    p.add_argument("--prefix_dim", type=int, default=None,
                   help="CLAP embedding dim; default 1024 with --is_rn else 512")
    p.add_argument("--only_soft_prompt", action="store_true")
    p.add_argument("--lora_r", type=int, default=8)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--percentage", type=float, default=1.0)
    p.add_argument("--normalize_prefix", action="store_true")
    p.add_argument("--use_audio_embedding", action="store_true")
    p.add_argument("--use_related_text", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_seq_len", type=int, default=40)
    return p


def _mistral_config(size: str, vocab_size: int):
    from zs_aac_tpu_torch.models.mistral import MistralConfig

    if size == "tiny":
        return MistralConfig(vocab_size=vocab_size, hidden_size=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, intermediate_size=64,
                             sliding_window=128, max_positions=128)
    return MistralConfig(vocab_size=max(vocab_size, 32000))


def extend_with_lang_tags(tokenizer):
    """A word tokenizer learns the language tags as words (in LANG_TAGS'
    order); a SentencePiece or BPE tokenizer splits them into pieces."""
    if hasattr(tokenizer, "stoi"):
        for tag in LANG_TAGS.values():
            if tag not in tokenizer.stoi:
                tokenizer.stoi[tag] = len(tokenizer.itos)
                tokenizer.itos.append(tag)
    return tokenizer


def load_mistral_base(path: str, device):
    """A JAX-written msgpack of the base -> the port's parameter dict, each
    leaf in the dtype it was stored in."""
    from zs_aac_tpu_torch.models.convert import from_jax_params
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    return from_jax_params(load_params(path, bf16_tensors=True), device=device)


@torch.no_grad()
def run_multilingual_validation(params, ccfg, val_ds, tokenizer, key2refs, lang: str = "en",
                                batch: int = 32, q8_cache=None, device="cuda"):
    """Batched greedy decode (chunks of ``batch``) with the language tag
    after the prefix; (CIDEr, key2pred). ``q8_cache=None`` takes the int8
    KV cache exactly when the served base is int8."""
    from zs_aac_tpu_torch.data.prompts import padding_captions
    from zs_aac_tpu_torch.decoding.greedy import mistral_greedy_decode
    from zs_aac_tpu_torch.eval.captioning import eval_prediction
    from zs_aac_tpu_torch.models.caption_mistral import mistral_caption_embeddings
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if q8_cache is None:
        q8_cache = isinstance(params["mistral"]["lm_head"], dict)
    tag_ids = torch.as_tensor(tokenizer.encode(LANG_TAGS[lang]), dtype=torch.int64, device=dev)
    key2pred = {}
    items = [val_ds[i] for i in range(len(val_ds))]
    for s in range(0, len(items), batch):
        chunk = items[s:s + batch]
        prefix = torch.from_numpy(np.stack([it["prefix"] for it in chunk])).to(dev)
        tags = tag_ids[None].expand(len(chunk), -1)
        hp = None
        if "hard_prompt" in chunk[0]:
            hp = torch.from_numpy(padding_captions([it["hard_prompt"] for it in chunk])[0]).to(dev)
        emb = mistral_caption_embeddings(params, ccfg, prefix, hp, tags)
        toks, lens = mistral_greedy_decode(params["mistral"], ccfg.mistral, emb, params["lora"],
                                           60, 2, q8_cache=q8_cache)
        toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
        for it, t, n in zip(chunk, toks, lens):
            key2pred[it["audio_id"]] = [tokenizer.decode(list(t[:int(n)])).lower()]
    out = eval_prediction(key2refs, key2pred, metrics=("CIDEr",))
    return out["CIDEr"], key2pred


@dataclasses.dataclass
class MultilingualTrainState:
    params: Any      # {"mapper": nn.Module, "lora": dict, "mistral": dict}, updated in place
    opt_state: Any
    step: int


def multilingual_labels(tree):
    """The optimizer's partition: the mapper and LoRA's a/b train; LoRA's
    ``r``/``alpha`` and the base are frozen."""
    return {"mapper": "trainable",
            "lora": {k: "frozen" if k in ("r", "alpha") else "trainable" for k in tree["lora"]},
            "mistral": "frozen"}


def make_multilingual_optimizer(schedule, weight_decay: float = 0.0):
    """optax's ``adamw`` on the trainable part, ``set_to_zero`` elsewhere."""
    from zs_aac_tpu_torch.train.optim import get_optimizer, multi_transform, set_to_zero

    return multi_transform({"trainable": get_optimizer(schedule, "adamw",
                                                       weight_decay=weight_decay),
                            "frozen": set_to_zero()}, multilingual_labels)


def _trainable(tree):
    """The mapper and LoRA a/b leaves of a ``tensor_tree``, keyed as paths."""
    from zs_aac_tpu_torch.train.optim import tree_leaves

    lora = {k: v for k, v in tree["lora"].items() if k not in ("r", "alpha")}
    return tree_leaves({"mapper": tree["mapper"], "lora": lora})


def _with_grads(tree, grads):
    """``tree`` with its trainable leaves replaced, in order, by ``grads``
    (the frozen leaves stay: ``set_to_zero`` reads only their shapes)."""
    it = iter(grads)

    def sub(t):
        return {k: sub(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    mapper = sub(tree["mapper"])
    lora = {k: (v if k in ("r", "alpha") else sub(v)) for k, v in tree["lora"].items()}
    return {"mapper": mapper, "lora": lora, "mistral": tree["mistral"]}


def make_multilingual_train_step(ccfg, optimizer, noise_variance: float = 0.0, device="cuda",
                                 mesh=None):
    """``train_step(state, batch, seed) -> (state, loss)``: noise into the
    prefix (``torch.Generator`` seeded with ``fold_in(seed, step)``), the
    training forward (``mistral_caption_train_logits``), cross-entropy past
    the language tag, gradients of the mapper and LoRA only, and the
    optimizer's update added in place. ``batch``: {"tokens", "mask",
    "prefix", ["hard_prompt", "hard_mask"]}, numpy or tensors.

    Under ``mesh`` (dims ``data`` x ``model``; the JAX dryrun's dp x tp
    Mistral + LoRA step) ``batch`` is this rank's ``data`` rows, the base
    and LoRA are this rank's shards (``parallel.tp.shard_mistral_params``,
    ``shard_mistral_lora``; whole where ``model`` has one rank) and the
    mapper is replicated: as the captioner's
    step, the noise is drawn for the global batch, each rank differentiates
    its share of the global loss, the gradients are summed over ``data``,
    and the loss returned is the global batch's."""
    from zs_aac_tpu_torch.models.caption_mistral import (mistral_caption_loss,
                                                         mistral_caption_train_logits)
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.train.contrastive import fold_in
    from zs_aac_tpu_torch.parallel.mesh import all_reduce_grads, all_sum, mesh_axis, tensor_axis
    from zs_aac_tpu_torch.train.optim import tree_leaves
    from zs_aac_tpu_torch.utils.device import resolve_device
    from zs_aac_tpu_torch.utils.noise import noise_injection

    dev = resolve_device(device)
    data, tp = mesh_axis(mesh, "data"), tensor_axis(mesh)

    def train_step(state: MultilingualTrainState, batch, seed: int):
        g = torch.Generator(device=dev).manual_seed(fold_in(seed, state.step))
        take = lambda k: torch.as_tensor(batch[k]).to(dev) if k in batch else None
        tree = tensor_tree(state.params)
        leaves = _trainable(tree)
        with torch.enable_grad():
            for p in tree_leaves(tree):
                p.requires_grad_(False)
            for p in leaves:
                p.requires_grad_(True)
            tokens = take("tokens")
            prefix = noise_injection(take("prefix").float(), noise_variance, generator=g,
                                     data=data)
            logits = mistral_caption_train_logits(state.params, ccfg, tokens, prefix,
                                                  take("mask"), take("hard_prompt"),
                                                  take("hard_mask"), tp=tp)
            share = mistral_caption_loss(logits, tokens, ccfg.islang, data)
            grads = torch.autograd.grad(share, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        grads = all_reduce_grads([torch.zeros_like(p) if gr is None else gr
                                  for p, gr in zip(leaves, grads)], data)
        with torch.no_grad():
            updates, opt_state = optimizer.update(_with_grads(tree, grads), state.opt_state, tree)
            for p, u in zip(leaves, _trainable(updates)):
                p.add_(u)
        loss = all_sum(share.detach(), data)
        return MultilingualTrainState(state.params, opt_state, state.step + 1), loss

    return train_step


def main(argv=None):
    args = build_parser().parse_args(argv)

    from zs_aac_tpu_torch.data.datasets import (CaptionBankDataset, CaptionBankTestDataset,
                                                CaptionDatasetConfig, caption_batches)
    from zs_aac_tpu_torch.data.prefetch import prefetch
    from zs_aac_tpu_torch.models.caption_mistral import (MistralCaptionConfig,
                                                         init_mistral_caption)
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.train.optim import cosine_lr
    from zs_aac_tpu_torch.train.train_prompt import _make_tokenizer
    from zs_aac_tpu_torch.utils.checkpoints import (criterion_improver, join_async_saves,
                                                    save_params_async)
    from zs_aac_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    np.random.seed(args.seed)
    tokenizer, _ = _make_tokenizer(args.tokenizer, args.data)
    extend_with_lang_tags(tokenizer)
    islang = len(tokenizer.encode(LANG_TAGS["en"]))

    dcfg = CaptionDatasetConfig(
        prefix_length=args.prefix_length,
        max_seq_len=args.max_seq_len,
        normalize_prefix=args.normalize_prefix,
        use_audio_embedding=args.use_audio_embedding,
        use_related_text=args.use_related_text,
        percentage=args.percentage,
        sound_effect_path=args.sound_effect,
        multilingual=True,
        lang_tags=tuple(LANG_TAGS.values()),
        seed=args.seed,
    )
    dataset = CaptionBankDataset(args.data, tokenizer, dcfg)
    val_ds = CaptionBankTestDataset(args.valdata, tokenizer, dcfg)
    key2refs = val_ds.references()

    prefix_dim = args.prefix_dim or (1024 if args.is_rn else 512)
    ccfg = MistralCaptionConfig(
        prefix_length=args.prefix_length,
        prefix_size=prefix_dim,
        clip_length=args.prefix_length_clip,
        num_layers=args.num_layers,
        mapping_type=args.mapping_type,
        only_soft_prompt=args.only_soft_prompt,
        islang=islang,
        max_seq_len=args.max_seq_len,
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        mistral=_mistral_config(args.mistral_size, tokenizer.vocab_size),
    )
    base = load_mistral_base(args.mistral_ckpt, device) if args.mistral_ckpt else None
    params = init_mistral_caption(ccfg, args.seed, device, mistral_params=base)

    out_dir = os.path.join(args.out_dir, time.strftime("%b-%d-%H-%M-%S", time.localtime()))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "params.json"), "w") as f:
        json.dump({**vars(args), "islang": islang,
                   "mistral_vocab_size": ccfg.mistral.vocab_size}, f)
    logger = logging.getLogger(f"train_caption_ml.{out_dir}")
    logger.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(out_dir, "train_caption.log"))
    logger.addHandler(handler)
    try:
        steps_per_epoch = max(len(dataset) // args.bs, 1)
        schedule = cosine_lr(args.lr, args.warmup * steps_per_epoch,
                             args.epochs * steps_per_epoch)
        optimizer = make_multilingual_optimizer(schedule, args.weight_decay)
        state = MultilingualTrainState(params, optimizer.init(tensor_tree(params)), 0)
        step_fn = make_multilingual_train_step(ccfg, optimizer, args.noise_variance, device)
        improved = criterion_improver("score")
        it = 0
        for epoch in range(args.epochs):
            print(f">>> Training epoch {epoch}", flush=True)
            losses = []
            for batch in prefetch(caption_batches(dataset, args.bs, seed=args.seed + epoch)):
                state, loss = step_fn(state, batch, args.seed + 1)
                losses.append(loss)
                it += 1
                if args.max_steps and it >= args.max_steps:
                    break
            score, _ = run_multilingual_validation(state.params, ccfg, val_ds, tokenizer,
                                                   key2refs, device=device)
            mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
            logger.info("%d\t%.3g\t%.3g", epoch, mean_loss, score)
            head = {"mapper": state.params["mapper"], "lora": state.params["lora"]}
            if improved(score):
                save_params_async(os.path.join(out_dir, "best.pth"), head)
            save_params_async(os.path.join(out_dir, "last.pth"), head)
            if args.max_steps and it >= args.max_steps:
                break
        join_async_saves()
    finally:
        logger.removeHandler(handler)
        handler.close()
    print(f"run dir: {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
