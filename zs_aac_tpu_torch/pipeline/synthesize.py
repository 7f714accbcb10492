"""Caption corpus synthesis and multilingual translation.

A copy of the JAX package's ``pipeline/synthesize.py``, itself after the
reference's ``prepare_ChatGPT.py`` (few-shot caption generation: select 5
mutually-dissimilar examples by CLAP similarity threshold 0.3, prompt an LLM
for 20 audio-focused captions per call), ``process_chatgpt.py`` (keep only
captions whose unigrams all appear in the training vocabulary),
``prepare_ChatGPT_multilingual.py`` and ``prepare_DeepL_multilingual.py``
(zh/fr caption translation adding ``cn_caption``/``fr_caption`` fields).
Banks are read and written by the port's ``data/banks.py``.

The LLM/DeepL calls are injected (``caller``) so the selection and filter
logic runs offline; the CLI builds an OpenAI or DeepL caller, importing the
client only then, and raises a ``RuntimeError`` that says what is missing
where the package or its API key is. As in the JAX package, the reference's
accidental repeated append of the first embedding during example selection
(``prepare_ChatGPT.py:40-47``) is NOT replicated: each newly selected
example's own embedding joins the pool.

Run:
  python -m zs_aac_tpu_torch.pipeline.synthesize generate --bank BANK.pkl --out caps.txt
  python -m zs_aac_tpu_torch.pipeline.synthesize filter --captions_txt caps.txt \
      --train_captions_txt train.txt --out kept.txt
  python -m zs_aac_tpu_torch.pipeline.synthesize translate --bank BANK.pkl \
      --engine deepl --out translated.pkl
"""

from __future__ import annotations

import argparse
import random
import re
from typing import Callable, Iterable, List, Optional, Sequence, Set

import numpy as np

__all__ = [
    "select_diverse_examples",
    "generation_prompt",
    "synthesize_captions",
    "vocabulary_filter",
    "translation_prompt",
    "translate_records",
]


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def select_diverse_examples(
    text_embeddings: np.ndarray,   # [N, E]
    threshold: float = 0.3,
    num_samples: int = 5,
    rng: Optional[random.Random] = None,
    max_tries: int = 10000,
) -> List[int]:
    """Pick indices whose pairwise CLAP similarity stays <= threshold
    (prepare_ChatGPT.py:32-49)."""
    rng = rng or random
    embs = _normalize(np.asarray(text_embeddings, np.float32))
    first = rng.randint(0, len(embs) - 1)
    chosen = [first]
    pool = embs[first][None]
    tries = 0
    while len(chosen) < num_samples and tries < max_tries:
        tries += 1
        i = rng.randint(0, len(embs) - 1)
        if i in chosen:
            continue
        if float(np.max(pool @ embs[i])) <= threshold:
            chosen.append(i)
            pool = np.concatenate([pool, embs[i][None]], axis=0)
    return chosen


def generation_prompt(example_captions: Sequence[str], n: int = 20) -> str:
    """The few-shot generation prompt (prepare_ChatGPT.py:76-86 semantics)."""
    examples = "\n".join(f"- {c}" for c in example_captions)
    return (
        "Here are some examples of audio captions describing sounds and "
        f"acoustic scenes:\n{examples}\n"
        f"Generate {n} new diverse captions in the same style. Each caption "
        "should describe sounds only (no visual details), be a single "
        "sentence, and end with a period. Output one caption per line."
    )


def synthesize_captions(
    caller: Callable[[str], str],
    text_embeddings: np.ndarray,
    captions: Sequence[str],
    total: int,
    per_call: int = 20,
    threshold: float = 0.3,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """N/per_call LLM rounds, each with freshly selected few-shot examples."""
    out: List[str] = []
    rounds = (total + per_call - 1) // per_call
    for _ in range(rounds):
        idx = select_diverse_examples(text_embeddings, threshold, 5, rng)
        prompt = generation_prompt([captions[i] for i in idx], per_call)
        try:
            reply = caller(prompt)
        except Exception as e:  # reference returns the error string (:18-29)
            reply = str(e)
        for line in reply.splitlines():
            line = re.sub(r"^\s*[-\d.)]*\s*", "", line).strip()
            if len(line.split()) >= 3:
                out.append(line)
    return out[:total]


def vocabulary_filter(captions: Iterable[str], train_vocab: Set[str]) -> List[str]:
    """Keep captions whose unigrams all appear in the training vocabulary
    (process_chatgpt.py:14-50; the bigram check there is disabled)."""
    kept = []
    for cap in captions:
        words = re.sub(r"[^\w\s']", " ", cap.lower()).split()
        if words and all(w in train_vocab for w in words):
            kept.append(cap)
    return kept


def translation_prompt(caption: str, language: str) -> str:
    name = {"zh": "Chinese", "fr": "French"}[language]
    return (
        f"Translate this audio caption into {name}; reply with the "
        f"translation only:\n{caption}"
    )


def translate_records(
    records: List[dict],
    caller: Callable[[str], str],
    languages: Sequence[str] = ("zh", "fr"),
) -> List[dict]:
    """Attach cn_caption/fr_caption fields (prepare_*_multilingual.py)."""
    field = {"zh": "cn_caption", "fr": "fr_caption"}
    out = []
    for rec in records:
        rec = dict(rec)
        for lang in languages:
            try:
                rec[field[lang]] = caller(translation_prompt(rec["caption"], lang))
            except Exception as e:
                rec[field[lang]] = str(e)
        out.append(rec)
    return out


def _client(module: str, key: str):
    """(the imported client package, its API key), or a RuntimeError that
    names what is missing."""
    import importlib
    import os

    try:
        pkg = importlib.import_module(module)
    except ImportError as e:
        raise RuntimeError(f"the {module!r} package is needed for this mode and is not "
                           "installed") from e
    if not os.environ.get(key):
        raise RuntimeError(f"set {key} to use the {module} client")
    return pkg, os.environ[key]


def _deepl_caller():
    """DeepL translation caller (prepare_DeepL_multilingual.py:11-16):
    needs the ``deepl`` package and ``DEEPL_AUTH_KEY``."""
    deepl, key = _client("deepl", "DEEPL_AUTH_KEY")
    translator = deepl.Translator(key)

    def call(prompt: str) -> str:
        # prompt is the raw caption when used via translate_records' caller
        text = prompt.splitlines()[-1]
        lang = "ZH" if "Chinese" in prompt else "FR"
        return translator.translate_text(text, target_lang=lang).text

    return call


def _openai_caller(model: str = "gpt-3.5-turbo"):
    """OpenAI chat caller: needs the ``openai`` package and ``OPENAI_API_KEY``."""
    openai, key = _client("openai", "OPENAI_API_KEY")
    client = openai.OpenAI(api_key=key)

    def call(prompt: str) -> str:
        r = client.chat.completions.create(
            model=model, messages=[{"role": "user", "content": prompt}]
        )
        return r.choices[0].message.content

    return call


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["generate", "filter", "translate"])
    p.add_argument("--bank", help="embedding bank with captions + text_embeddings")
    p.add_argument("--captions_txt", help="caption lines (filter mode input)")
    p.add_argument("--train_captions_txt", help="vocabulary source (filter mode)")
    p.add_argument("--out", required=True)
    p.add_argument("--total", type=int, default=100)
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--model", default="gpt-3.5-turbo")
    p.add_argument("--engine", choices=["openai", "deepl"], default="openai")
    args = p.parse_args(argv)

    if args.mode == "filter":
        with open(args.train_captions_txt) as f:
            vocab = set(
                w for line in f
                for w in re.sub(r"[^\w\s']", " ", line.lower()).split()
            )
        with open(args.captions_txt) as f:
            caps = [l.strip() for l in f if l.strip()]
        kept = vocabulary_filter(caps, vocab)
        with open(args.out, "w") as f:
            f.write("\n".join(kept) + "\n")
        print(f"kept {len(kept)}/{len(caps)} captions")
        return

    from zs_aac_tpu_torch.data.banks import read_bank

    records = read_bank(args.bank)
    caller = _deepl_caller() if args.engine == "deepl" else _openai_caller(args.model)
    if args.mode == "generate":
        embs = np.concatenate(
            [np.asarray(r["text_embedding"], np.float32).reshape(1, -1)
             for r in records]
        )
        caps = [r["caption"] for r in records]
        out = synthesize_captions(caller, embs, caps, args.total,
                                  threshold=args.threshold)
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
        print(f"generated {len(out)} captions")
    else:
        from zs_aac_tpu_torch.data.banks import write_bank_stream

        out = translate_records(records, caller)
        write_bank_stream(args.out, out)
        print(f"translated {len(out)} records")


if __name__ == "__main__":
    main()
