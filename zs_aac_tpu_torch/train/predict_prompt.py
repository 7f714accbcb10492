"""Captioner inference/eval CLI, greedy and beam decoding.

The port of the JAX package's ``train/predict_prompt.py`` greedy and
``--isbeam`` paths: the run dir's ``params.json`` rehydrates the model and
tokenizer, ``best.pth`` (the JAX package's msgpack snapshot) loads through
the port's own reader, the test bank decodes in padded chunks of up to 256
clips greedy or 64 clips beam (``--beam_size`` beams, the best one kept;
float weights, or ``--q8`` for w8a8 weights + the int8 KV cache through
kernel K1), grouped by the length of their ``--sound_effect`` hard prompt
(AudioSet labels nearest the clip, "There are a, b, c in this audio."),
and the run dir gets ``output.txt``, ``scores.txt`` and ``timing.json``
with the JAX CLI's contracts. Each prefix slot is also shown as its nearest
vocab token.

Run: ``python -m zs_aac_tpu_torch.train.predict_prompt --test_dir RUN --data test.pkl``
(``--device cpu`` runs on the CPU; the default is ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["build_parser", "main"]

_LATER = "is ported in a later slice of the PyTorch port (see ROADMAP.md)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test_dir", required=True, help="run dir with params.json/best.pth")
    p.add_argument("--data", required=True, help="test embedding bank (.pkl)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--sound_effect", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--isbeam", action="store_true")
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--magic", action="store_true")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--beta", type=float, default=0.2)
    p.add_argument("--magic_width", type=int, default=25)
    p.add_argument("--clap_ckpt", default=None, help="ASE checkpoint for MAGIC")
    p.add_argument("--batch", type=int, default=32, help="greedy decode batch size")
    p.add_argument("--q8", action="store_true",
                   help="serve with int8 weights (w8a8) + int8 KV cache (greedy/beam)")
    p.add_argument("--bf16_softmax", action="store_true",
                   help="approximate mode: beam attention softmax in bf16")
    p.add_argument("--q8_tower", action="store_true",
                   help="approximate mode for --magic: w8a8 CLAP text tower")
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
    from zs_aac_tpu_torch.data.banks import iter_bank
    from zs_aac_tpu_torch.data.tokenizer import GPT2BPETokenizer, WordTokenizer

    if tokenizer_path:
        if tokenizer_path.endswith(".model"):
            raise NotImplementedError(f"the SentencePiece tokenizer {_LATER}")
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


@torch.no_grad()
def main(argv=None):
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()

    from zs_aac_tpu_torch.data.datasets import CaptionBankTestDataset, CaptionDatasetConfig
    from zs_aac_tpu_torch.decoding.beam import beam_search_batched, beam_search_batched_q8
    from zs_aac_tpu_torch.decoding.greedy import greedy_decode, greedy_decode_q8
    from zs_aac_tpu_torch.eval.captioning import eval_prediction
    from zs_aac_tpu_torch.models.caption import CaptionConfig, caption_embeddings
    from zs_aac_tpu_torch.models.convert import from_jax_params
    from zs_aac_tpu_torch.models.gpt2 import quantize_gpt2_int8
    from zs_aac_tpu_torch.utils.checkpoints import load_params
    from zs_aac_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with open(os.path.join(args.test_dir, "params.json")) as f:
        saved = json.load(f)
    if args.magic:
        raise NotImplementedError(f"--magic (MAGIC decoding) {_LATER}")
    if args.bf16_softmax:
        raise NotImplementedError(f"--bf16_softmax (bf16 beam attention softmax) {_LATER}")
    if args.q8_tower:
        raise NotImplementedError(f"--q8_tower (MAGIC's int8 text tower) {_LATER}")

    tokenizer, stop_id = _make_tokenizer(args.tokenizer or saved.get("tokenizer"),
                                         saved["data"])
    dcfg = CaptionDatasetConfig(prefix_length=saved["prefix_length"],
                                normalize_prefix=saved.get("normalize_prefix", False),
                                sound_effect_path=args.sound_effect or saved.get("sound_effect"),
                                sound_effect_k=3)
    ds = CaptionBankTestDataset(args.data, tokenizer, dcfg)
    key2refs = ds.references()

    prefix_dim = saved.get("prefix_dim") or (1024 if saved.get("is_rn") else 512)
    ccfg = CaptionConfig(
        prefix_length=saved["prefix_length"],
        prefix_size=prefix_dim,
        clip_length=saved.get("prefix_length_clip", saved["prefix_length"]),
        num_layers=saved.get("num_layers", 8),
        mapping_type=saved.get("mapping_type", "mlp"),
        only_soft_prompt=saved.get("only_soft_prompt", False),
        gpt2=_gpt2_config(saved.get("gpt2_size", "base"),
                          saved.get("gpt2_vocab_size", tokenizer.vocab_size)),
    )
    params = from_jax_params(load_params(os.path.join(args.test_dir, "best.pth")),
                             device=device)
    gpt2_serving, decode_greedy, decode_beam = params["gpt2"], greedy_decode, beam_search_batched
    if args.q8:
        gpt2_serving = quantize_gpt2_int8(params["gpt2"], "w8a8")
        decode_greedy, decode_beam = greedy_decode_q8, beam_search_batched_q8

    # nearest-vocab interpretation of each prefix slot
    wte = params["gpt2"]["wte"].float()
    wte_n = wte / torch.clamp_min(torch.linalg.norm(wte, dim=-1, keepdim=True), 1e-12)

    def chunk_prefix_tokens(emb):
        e = emb[:, -ccfg.prefix_length:].float()
        e = e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), 1e-12)
        ids = (e @ wte_n.t()).argmax(dim=-1).cpu().numpy()
        return [tokenizer.decode(list(r)) for r in ids]

    key2pred, key2prefix = {}, {}
    items = [ds[i] for i in range(len(ds))]
    t_setup = time.perf_counter()
    chunk_walls = []
    groups = defaultdict(list)
    for it in items:
        groups[len(it.get("hard_prompt", ()))].append(it)
    chunk = min(args.batch, 64 if args.isbeam else 256)
    for h, group in groups.items():
        for s in range(0, len(group), chunk):
            part = group[s:s + chunk]
            tc = time.perf_counter()
            padded = part + [part[-1]] * (chunk - len(part))
            prefix = torch.from_numpy(np.stack([it["prefix"] for it in padded])).to(device)
            hp = (torch.from_numpy(np.stack([it["hard_prompt"] for it in padded])).to(device)
                  if h else None)
            emb = caption_embeddings(params, ccfg, prefix, hp)
            ptoks = chunk_prefix_tokens(emb)
            if args.isbeam:
                toks, lens, beam_scores = decode_beam(gpt2_serving, ccfg.gpt2, emb,
                                                      args.beam_size, 67, stop_id, 1.0)
                best = beam_scores.argmax(dim=1)   # the first of equal scores, as np.argmax
                rows = torch.arange(len(padded), device=best.device)
                toks, lens = toks[rows, best], lens[rows, best]
            else:
                toks, lens = decode_greedy(gpt2_serving, ccfg.gpt2, emb, 67, stop_id, 764)
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            for b, it in enumerate(part):
                key2prefix[it["audio_id"]] = [ptoks[b]]
                ids = list(toks[b][: int(lens[b])])
                key2pred[it["audio_id"]] = [tokenizer.decode(ids).lower()]
            chunk_walls.append(round(time.perf_counter() - tc, 3))

    t_decode = time.perf_counter()
    scores = eval_prediction(key2refs, key2pred)

    with open(os.path.join(args.test_dir, "scores.txt"), "w") as f:
        for n in range(4):
            f.write("Bleu-{}: {:6.4f}\n".format(n + 1, scores["Bleu"][n]))
        f.write("ROUGE_L: {:6.4f}\n".format(scores["ROUGE_L"]))
        f.write("CIDEr: {:6.4f}\n".format(scores["CIDEr"]))
        if scores["METEOR"] is not None:
            f.write("METEOR: {:6.4f}\n".format(scores["METEOR"]))
        if scores["SPICE"] is not None:
            f.write("SPICE: {:6.4f}\n".format(scores["SPICE"]))
        f.write("SPIDEr: {:6.4f}\n".format(scores["SPIDEr"]))
        if scores.get("SPIDEr_approx"):
            f.write("# SPICE/SPIDEr from the pure-Python scene-graph scorer "
                    "(no Java SPICE stack)\n")

    pred_data = [
        {"filename": k, "caption": "".join(v[0]), "prefix": "".join(key2prefix[k][0])}
        for k, v in key2pred.items()
    ]
    with open(os.path.join(args.test_dir, "output.txt"), "w") as f:
        json.dump({"predictions": pred_data}, f, indent=2, ensure_ascii=False)

    t_end = time.perf_counter()
    timing = {
        "setup_s": round(t_setup - t0, 2),
        "decode_s": round(t_decode - t_setup, 2),
        "chunk_walls_s": chunk_walls,
        "decode_steady_clips_per_s": (
            round(args.batch * (len(chunk_walls) - 1)
                  / max(sum(chunk_walls[1:]), 1e-9), 1)
            if len(chunk_walls) > 1 else None),
        "eval_and_write_s": round(t_end - t_decode, 2),
        "total_s": round(t_end - t0, 2),
        "n_clips": len(items),
        "device": str(device),
    }
    with open(os.path.join(args.test_dir, "timing.json"), "w") as f:
        json.dump(timing, f, indent=1)
    print("[timing] " + json.dumps(timing))
    print(json.dumps({k: v for k, v in scores.items() if k != "Bleu"}, default=float))
    return scores


if __name__ == "__main__":
    main()
