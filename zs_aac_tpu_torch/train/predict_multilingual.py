"""Multilingual captioner inference/eval driver (CLI).

The port of the JAX package's ``train/predict_multilingual.py``: the run
dir's ``params.json`` rehydrates the tokenizer and the Mistral captioner,
``best.pth`` (either package's msgpack snapshot of ``{"mapper", "lora"}``)
loads over the base, and each clip is captioned in every ``--langs``
language by putting that language's tag after the prefix (batched greedy,
eos 2, at most 60 tokens). Per language the references
(``caption``/``cn_caption``/``fr_caption``) and predictions are
pre-tokenized (characters for zh, regex words for en/fr) and scored with
BLEU, ROUGE-L and CIDEr into ``scores_{lang}.txt``; ``output.txt`` holds
every clip's captions.

``--mistral_ckpt`` (or the run's) is a JAX-written msgpack of the base,
served in the dtype it was stored in (flax restores the stored dtype, not
its template's); without one the base is random bf16 from the port's
generator seeded with 0, which cannot equal the JAX driver's. ``--q8`` serves
the base as w8a8 int8 weights (LoRA stays float on top) with the int8 KV
cache; ``--fuse_qkv`` concatenates q/k/v and gate/up (``auto``: fused for
192 <= ``--batch`` < 384, the JAX driver's rule).

Run: ``python -m zs_aac_tpu_torch.train.predict_multilingual --test_dir RUN
--data test.pkl`` (``--device cpu`` runs on the CPU; the default is ``cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch

__all__ = ["build_parser", "main", "tokenize_lang", "LANGS", "REF_FIELD"]

LANGS = ("en", "zh", "fr")
REF_FIELD = {"en": "caption", "zh": "cn_caption", "fr": "fr_caption"}


def tokenize_lang(text: str, lang: str) -> str:
    """Language-aware pre-tokenization -> space-joined tokens."""
    text = text.strip().lower()
    if lang == "zh":
        text = re.sub(r"[^\w一-鿿]+", "", text)
        return " ".join(list(text))
    toks = re.findall(r"[a-zà-ÿ0-9]+(?:'[a-zà-ÿ]+)?", text)
    return " ".join(toks)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test_dir", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--sound_effect", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--mistral_ckpt", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--langs", nargs="+", default=list(LANGS))
    p.add_argument("--q8", action="store_true",
                   help="serve the frozen base with w8a8 int8 weights and the int8 KV "
                        "cache (LoRA stays float on top)")
    p.add_argument("--fuse_qkv", choices=("auto", "on", "off"), default="auto",
                   help="serve the int8 base with q/k/v and gate/up concatenated into "
                        "single projections (the same int8 values and scales); 'auto' "
                        "fuses for 192 <= --batch < 384")
    return p


@torch.no_grad()
def main(argv=None):
    args = build_parser().parse_args(argv)

    from zs_aac_tpu_torch.data.datasets import CaptionBankTestDataset, CaptionDatasetConfig
    from zs_aac_tpu_torch.eval.captioning import eval_prediction
    from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig
    from zs_aac_tpu_torch.models.mapper import make_mapper
    from zs_aac_tpu_torch.models.mistral import init_lora, init_mistral, quantize_mistral_int8
    from zs_aac_tpu_torch.train.train_prompt import _load_ckpt, _make_tokenizer
    from zs_aac_tpu_torch.train.train_prompt_multilingual import (_mistral_config,
                                                                  extend_with_lang_tags,
                                                                  load_mistral_base,
                                                                  run_multilingual_validation)
    from zs_aac_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with open(os.path.join(args.test_dir, "params.json")) as f:
        saved = json.load(f)

    tokenizer, _ = _make_tokenizer(args.tokenizer or saved.get("tokenizer"), saved["data"])
    extend_with_lang_tags(tokenizer)
    dcfg = CaptionDatasetConfig(
        prefix_length=saved["prefix_length"],
        normalize_prefix=saved.get("normalize_prefix", False),
        sound_effect_path=args.sound_effect or saved.get("sound_effect"),
    )
    ds = CaptionBankTestDataset(args.data, tokenizer, dcfg)

    ccfg = MistralCaptionConfig(
        prefix_length=saved["prefix_length"],
        prefix_size=saved.get("prefix_dim") or (1024 if saved.get("is_rn") else 512),
        clip_length=saved.get("prefix_length_clip", saved["prefix_length"]),
        num_layers=saved.get("num_layers", 8),
        mapping_type=saved.get("mapping_type", "mlp"),
        only_soft_prompt=saved.get("only_soft_prompt", False),
        islang=saved.get("islang", 1),
        lora_r=saved.get("lora_r", 8),
        lora_alpha=saved.get("lora_alpha", 16),
        mistral=_mistral_config(saved.get("mistral_size", "7b"),
                                saved.get("mistral_vocab_size", tokenizer.vocab_size)),
    )
    mistral_ckpt = args.mistral_ckpt or saved.get("mistral_ckpt")
    base = (load_mistral_base(mistral_ckpt, device) if mistral_ckpt
            else init_mistral(ccfg.mistral, 0, device))
    # best.pth must hold this model's mapper and LoRA, leaf for leaf (as
    # flax's restore into its template demands)
    template = {"mapper": make_mapper(ccfg.mapping_type, ccfg.prefix_size,
                                      ccfg.mistral.hidden_size, ccfg.prefix_length,
                                      ccfg.clip_length, ccfg.num_layers, "meta"),
                "lora": init_lora(ccfg.mistral, ccfg.lora_r, ccfg.lora_alpha, device="cpu")}
    head = _load_ckpt(template, os.path.join(args.test_dir, "best.pth"), device)
    params = {"mapper": head["mapper"], "lora": head["lora"], "mistral": base}
    if args.q8:
        fuse = args.fuse_qkv == "on" or (args.fuse_qkv == "auto" and 192 <= args.batch < 384)
        params["mistral"] = quantize_mistral_int8(params["mistral"], "w8a8", fuse=fuse)
        del base

    all_preds = {}
    for lang in args.langs:
        key2refs = {}
        for rec in ds.records:
            caps = rec["caption"]
            caps = caps if isinstance(caps, list) else [{"caption": caps}]
            refs = []
            for c in caps:
                c = c if isinstance(c, dict) else {"caption": c}
                refs.append(str(c.get(REF_FIELD[lang], c.get("caption", ""))))
            key2refs[rec["audio_id"]] = [tokenize_lang(r, lang) for r in refs if r]
        key2refs = {k: v or [""] for k, v in key2refs.items()}
        _, key2pred = run_multilingual_validation(params, ccfg, ds, tokenizer, key2refs,
                                                  lang=lang, batch=args.batch, device=device)
        key2pred_tok = {k: [tokenize_lang(v[0], lang)] for k, v in key2pred.items()}
        scores = eval_prediction(key2refs, key2pred_tok, metrics=("Bleu", "ROUGE_L", "CIDEr"),
                                 pretokenized=True)
        with open(os.path.join(args.test_dir, f"scores_{lang}.txt"), "w") as f:
            for n in range(4):
                f.write("Bleu-{}: {:6.4f}\n".format(n + 1, scores["Bleu"][n]))
            f.write("ROUGE_L: {:6.4f}\n".format(scores["ROUGE_L"]))
            f.write("CIDEr: {:6.4f}\n".format(scores["CIDEr"]))
            f.write("# tokenization: char-level (zh) / regex words (en,fr); "
                    "reference uses stanza\n")
        all_preds[lang] = key2pred
        print(lang, {k: round(v, 4) for k, v in scores.items() if isinstance(v, float)})

    out = []
    for key in next(iter(all_preds.values())):
        rec = {"filename": key}
        for lang in args.langs:
            rec[f"caption_{lang}"] = all_preds[lang][key][0]
        out.append(rec)
    with open(os.path.join(args.test_dir, "output.txt"), "w") as f:
        json.dump({"predictions": out}, f, indent=2, ensure_ascii=False)
    return all_preds

