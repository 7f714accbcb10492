"""Committed test fixtures.

``tiny_captioner/``: a converged tiny captioner made by the JAX package's
CLIs (``tests/test_torch_predict.py`` regenerates it with
``PYTHONPATH=. python tests/test_torch_predict.py --write-fixture``).

``tiny_captioner/`` holds the run dir's ``params.json`` and ``best.pth``, the
training bank's captions (``train.pkl``, from which the word tokenizer is
rebuilt), the test bank (``test.pkl``) and ``expected.json``: the captions
the JAX package's ``predict_prompt`` wrote for the test bank, greedy float
and ``--q8``, beam (``--isbeam``) float and ``--q8``, and MAGIC
(``--magic --magic_width 5`` with the tiny CLAP checkpoint below: alone,
``--isbeam``, ``--q8``, ``--q8_tower``; ``tests/test_torch_magic.py
--write-fixture`` records these four on the committed ``best.pth``).

``tiny_clap/``: the CLAP checkpoint MAGIC reads (``ase.msgpack``, the JAX
package's parameter snapshot: a tiny Cnn14 audio tower, channels (4, 8) over
64 mels, with ``tiny_ase``'s text tower; its ``.json`` sidecar and
``vocab.txt``), and ``audio_expected.json``: the JAX package's audio
embeddings of ``clap_waves()`` (``tests/test_torch_magic.py --write-fixture``
writes all of it).

``tiny_ase/``: a tiny CLAP model for the encode half (``tests/
test_torch_extract.py --write-fixture`` regenerates it): ``ase.pt``, a
reference-layout state dict (HTSAT at the tiny geometry of
``tests/test_htsat.py`` plus a 2-layer BERT), ``vocab.txt``, four 16-bit
44.1 kHz WAVs under ``audio/`` with ``wav.csv`` and ``text.json``,
``config.json`` (the extract config) and ``expected.json``: the bank records
the JAX package's ``extract_audio_text_bank`` wrote for them; and
``train_expected.json`` (``tests/test_torch_train_step.py --write-fixture``):
the JAX package's ``make_ase_train_step`` on this model and a batch of the
four WAVs (``train_batch``: each clip with each of its two captions, the
clip index as the positive id), ``TRAIN_STEPS`` steps of ``TRAIN_OPTIM``:
the losses, per-leaf checksums of the updated parameters (``checksums``)
and the updated batch statistics.

``tiny_text_towers/``: two tiny ASEs with the CLIP and GPT-2 text towers,
written by the JAX package (``PYTHONPATH=. python
tests/test_torch_text_towers.py --write-fixture`` regenerates them):
``gpt2-tiny.msgpack`` and ``clip-tiny.msgpack`` (its parameter snapshots of
a seeded init: Cnn14 (4, 8) over 64 mels, embed 32, the tower named), each
with its ``.json`` sidecar, ``tiny_clap``'s ``vocab.txt``, and
``expected.json``: the id matrix (first tokens varied, padded rows) and
mask, and per tower the JAX towers' hidden states ``[B, L, D]`` and the
ASE's text embeddings of those ids, and the captions JAX ``predict_prompt
--magic --magic_width 5`` wrote for the tiny captioner's test bank with
each checkpoint as ``--clap_ckpt``.

``toy_clap/``: the CLAP of the JAX package's end-to-end toy
(``examples/end_to_end_toy.py``: Cnn14 (4, 8) and a 2-layer BERT over the
toy's vocabulary, embed 16), trained by the JAX pretrain CLI at the toy's
config and seed 20 (``PYTHONPATH=. python tests/test_torch_toy.py
--write-fixture`` regenerates it): ``clap.pt``, its best checkpoint as the
port's ``{"params", "batch_stats"}`` file, and ``expected.json``: the JAX
extract's audio embeddings of the toy's 24 clips, the pretrain's lowest
epoch loss, their mean pairwise cosine and the supervised captions naming
their class that the JAX toy's stage 8 wrote from those banks.

``tiny_mistral/``: a tiny Mistral + LoRA multilingual captioner made by the
JAX package's CLIs (``PYTHONPATH=. python tests/test_torch_multilingual.py
--write-fixture`` regenerates it): ``spm.model``, a SentencePiece BPE model
of the banks' words (``write_word_bpe_model``; a vocabulary that is not a
multiple of 8), the train and test banks (English, Chinese and French
captions), ``base.msgpack`` (the JAX package's random fp32 base at
``_mistral_config("tiny")``), ``run/`` (``params.json`` and ``best.pth`` of
a JAX ``train_prompt_multilingual`` run on that base) and
``expected.json``: the ``output.txt`` predictions of JAX
``predict_multilingual`` on the run dir, float and ``--q8 --fuse_qkv on``,
and a record of ``MISTRAL_TRAIN_STEPS`` steps of the JAX package's LoRA
train step on ``mistral_train_batch()`` from the run's ``best.pth`` (losses
and checksums of the mapper and LoRA).
"""

from __future__ import annotations

import csv
import json
import shutil
from pathlib import Path

import numpy as np

__all__ = ["FIXTURE_DIR", "TINY_ASE_DIR", "TINY_CLAP_DIR", "stage_tiny_captioner", "stage_tiny_ase",
           "train_batch", "checksums", "clap_waves", "TRAIN_STEPS", "TRAIN_OPTIM",
           "CAPTION_TRAIN_STEPS", "CAPTION_TRAIN_OPTIM", "caption_fixture_config",
           "caption_train_batch", "replay_caption_train_fixture", "TINY_MISTRAL_DIR",
           "MISTRAL_TRAIN_STEPS", "MISTRAL_TRAIN_OPTIM", "write_word_bpe_model",
           "stage_tiny_mistral", "mistral_fixture_config", "mistral_train_batch",
           "replay_mistral_train_fixture", "TINY_TEXT_TOWERS_DIR", "TEXT_TOWERS",
           "stage_tiny_text_towers", "TOY_CLAP_DIR"]

# the recorded train run: Adam under a clip of the global norm at 2, cosine
# schedule with one warmup step over TRAIN_STEPS steps
TRAIN_STEPS = 3
TRAIN_OPTIM = {"lr": 1e-3, "warmup": 1, "clip": 2.0, "optimizer": "adam"}

# the recorded captioner run: AdamW with decay, linear warmup over one step
# then linear decay to 0 at CAPTION_TRAIN_STEPS + 1, noise 0
CAPTION_TRAIN_STEPS = 3
CAPTION_TRAIN_OPTIM = {"lr": 1e-3, "warmup": 1, "weight_decay": 0.01}

# the recorded Mistral LoRA run: AdamW with decay at a constant lr, noise 0
MISTRAL_TRAIN_STEPS = 3
MISTRAL_TRAIN_OPTIM = {"lr": 1e-3, "weight_decay": 0.01}

FIXTURE_DIR = Path(__file__).resolve().parent / "tiny_captioner"
TINY_MISTRAL_DIR = Path(__file__).resolve().parent / "tiny_mistral"
TINY_ASE_DIR = Path(__file__).resolve().parent / "tiny_ase"
TINY_CLAP_DIR = Path(__file__).resolve().parent / "tiny_clap"
TINY_TEXT_TOWERS_DIR = Path(__file__).resolve().parent / "tiny_text_towers"
TOY_CLAP_DIR = Path(__file__).resolve().parent / "toy_clap"
TEXT_TOWERS = ("gpt2-tiny", "clip-tiny")


def clap_waves() -> np.ndarray:
    """The waves whose embeddings ``tiny_clap/audio_expected.json`` records:
    three 2 s clips at 32 kHz, a tone (220, 1000, 5000 Hz) under seeded
    noise; [3, 64000] float32."""
    rng = np.random.default_rng(12)
    t = np.arange(64000) / 32000.0
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
                     for f in (220.0, 1000.0, 5000.0)]).astype(np.float32)


def stage_tiny_captioner(dst) -> dict:
    """Copy the fixture into ``dst`` as a run dir plus banks, with the
    recorded training-bank path pointed at the copy, and the tiny CLAP
    checkpoint with its sidecar's vocabulary pointed at a copy. Returns
    {"run_dir", "test_bank", "clap_ckpt", "expected"}."""
    dst = Path(dst)
    run = dst / "run"
    run.mkdir(parents=True, exist_ok=True)
    for name in ("train.pkl", "test.pkl"):
        shutil.copy(FIXTURE_DIR / name, dst / name)
    shutil.copy(FIXTURE_DIR / "best.pth", run / "best.pth")
    params = json.loads((FIXTURE_DIR / "params.json").read_text())
    params["data"] = [str(dst / "train.pkl")]
    (run / "params.json").write_text(json.dumps(params))
    clap = dst / "clap"
    clap.mkdir(exist_ok=True)
    for name in ("ase.msgpack", "vocab.txt"):
        shutil.copy(TINY_CLAP_DIR / name, clap / name)
    sidecar = json.loads((TINY_CLAP_DIR / "ase.msgpack.json").read_text())
    sidecar["bert_tokenizer"] = str(clap / sidecar["bert_tokenizer"])
    (clap / "ase.msgpack.json").write_text(json.dumps(sidecar))
    return {"run_dir": str(run), "test_bank": str(dst / "test.pkl"),
            "clap_ckpt": str(clap / "ase.msgpack"),
            "expected": json.loads((FIXTURE_DIR / "expected.json").read_text())}


def stage_tiny_text_towers(dst) -> dict:
    """Copy the two tiny-tower ASE checkpoints into ``dst`` with their
    sidecars' vocabulary pointed at a copy. Returns {tower name: checkpoint
    path} and "expected": the record."""
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(TINY_TEXT_TOWERS_DIR / "vocab.txt", dst / "vocab.txt")
    out = {"expected": json.loads((TINY_TEXT_TOWERS_DIR / "expected.json").read_text())}
    for name in TEXT_TOWERS:
        shutil.copy(TINY_TEXT_TOWERS_DIR / f"{name}.msgpack", dst / f"{name}.msgpack")
        sidecar = json.loads((TINY_TEXT_TOWERS_DIR / f"{name}.msgpack.json").read_text())
        sidecar["bert_tokenizer"] = str(dst / sidecar["bert_tokenizer"])
        (dst / f"{name}.msgpack.json").write_text(json.dumps(sidecar))
        out[name] = str(dst / f"{name}.msgpack")
    return out


def stage_tiny_ase(dst) -> dict:
    """Copy the tiny-ASE fixture into ``dst/data`` with ``wav.csv`` and the
    config's vocab pointed at the copy. Returns {"config", "ckpt",
    "data_path", "expected"}."""
    data = Path(dst) / "data"
    shutil.copytree(TINY_ASE_DIR, data)
    with open(data / "wav.csv") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    with open(data / "wav.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["audio_id", "file_name"], delimiter="\t")
        w.writeheader()
        for r in rows:
            w.writerow({"audio_id": r["audio_id"], "file_name": str(data / r["file_name"])})
    config = json.loads((data / "config.json").read_text())
    config["text_encoder_args"]["vocab"] = str(data / "vocab.txt")
    return {"config": config, "ckpt": str(data / "ase.pt"), "data_path": str(data),
            "expected": json.loads((data / "expected.json").read_text())}


def train_batch(data_dir=TINY_ASE_DIR) -> dict:
    """The recorded train batch (numpy): every clip of the fixture with each
    of its captions, waves decoded and resampled to 32 kHz on the host
    (``load_wav`` + ``resample``, no native decoder), cut or padded to
    ``max_length``; ``idx`` is the clip's index, so a clip's two captions
    are positives of each other."""
    from zs_aac_tpu_torch.data.audio_io import load_wav, pad_or_truncate, resample
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.data.text_transform import text_preprocess

    data_dir = Path(data_dir)
    config = json.loads((data_dir / "config.json").read_text())
    args = config["audio_args"]
    with open(data_dir / "wav.csv") as f:
        files = {r["audio_id"]: r["file_name"] for r in csv.DictReader(f, delimiter="\t")}
    audios = json.loads((data_dir / "text.json").read_text())["audios"]
    waves, texts, idx = [], [], []
    for i, a in enumerate(audios):
        x, sr = load_wav(str(data_dir / files[a["audio_id"]]))
        wave = pad_or_truncate(resample(x, sr, args["sr"]), args["max_length"] * args["sr"])
        for c in a["captions"]:
            waves.append(wave)
            texts.append(text_preprocess(c["caption"]))
            idx.append(i)
    tok = WordPieceTokenizer.from_file(str(data_dir / "vocab.txt"))
    ids, mask = tok.batch_encode(texts, max_length=30, pad_to_max=True)
    return {"wave": np.stack(waves).astype(np.float32), "input_ids": ids,
            "attention_mask": mask, "idx": np.asarray(idx, np.int64)}


def checksums(tree, prefix="") -> dict:
    """Per leaf of a nested dict of arrays: [sum, sum of |x|, sum of x^2,
    sum of x * w] in float64, w a fixed ramp over the flattened leaf (so a
    permuted or misplaced update changes it)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(checksums(v, f"{prefix}{k}/"))
            continue
        a = np.asarray(v, np.float64).reshape(-1)
        w = np.linspace(-1.0, 1.0, a.size) if a.size > 1 else np.ones(1)
        out[f"{prefix}{k}"] = [float(a.sum()), float(np.abs(a).sum()),
                               float((a * a).sum()), float((a * w).sum())]
    return out


def train_optimizer():
    """The port's optimizer of the recorded run."""
    from zs_aac_tpu_torch.train.optim import (chain, clip_by_global_norm, cosine_lr,
                                              get_optimizer)

    o = TRAIN_OPTIM
    return chain(clip_by_global_norm(o["clip"]),
                 get_optimizer(cosine_lr(o["lr"], o["warmup"], TRAIN_STEPS), o["optimizer"]))


def replay_train_fixture(device="cuda", **config_overrides) -> dict:
    """The recorded run through the port's ``make_ase_train_step`` on
    ``device`` (``config_overrides`` set e.g. ``fused_attn``/``fused_block``
    in the fixture's config): {"losses", "checksums", "batch_stats"}."""
    import torch

    from zs_aac_tpu_torch.models.convert import convert_ase
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    config = {**json.loads((TINY_ASE_DIR / "config.json").read_text()), **config_overrides}
    ase, cfg = build_ase_from_config(config, device=device)
    sd = torch.load(TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    optimizer = train_optimizer()
    state = create_ase_state(0, ase, optimizer, device=device,
                             variables=convert_ase(sd, cfg, device=device))
    step = make_ase_train_step(ase, optimizer, LogMelConfig.from_dict(config["audio_args"]),
                               device=device)
    batch = train_batch()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, batch, 0)
        losses.append(float(loss))
    as_np = lambda t: {k: as_np(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.detach().float().cpu().numpy()
    stats = as_np(state.batch_stats)["audio_enc"]["bn0"]
    return {"losses": losses, "checksums": checksums(as_np(state.params)),
            "batch_stats": {k: v.tolist() for k, v in stats.items()}}


def caption_fixture_config() -> dict:
    """The tiny captioner's ``CaptionConfig`` fields (its ``params.json``),
    with its GPT-2's under "gpt2"."""
    saved = json.loads((FIXTURE_DIR / "params.json").read_text())
    return {"prefix_length": saved["prefix_length"], "prefix_size": saved["prefix_dim"],
            "clip_length": saved["prefix_length_clip"], "num_layers": saved["num_layers"],
            "mapping_type": saved["mapping_type"],
            "gpt2": {"vocab_size": saved["gpt2_vocab_size"], "n_positions": 128, "n_embd": 64,
                     "n_layer": 2, "n_head": 4}}


def caption_train_batch() -> dict:
    """The recorded captioner batch (numpy): the first 8 captions of the
    fixture's training bank (word tokenizer of the run, ending '.', padded
    to 12 tokens behind ``prefix_length`` mask ones), each with a noisy
    one-hot-block embedding of its caption's cluster (i % 4), as the run's
    bank was made."""
    import pickle

    from zs_aac_tpu_torch.train.train_prompt import _make_tokenizer

    bank = str(FIXTURE_DIR / "train.pkl")
    tok, _ = _make_tokenizer(None, [bank])
    with open(bank, "rb") as f:
        records = pickle.load(f)[:8]
    P, S, E = caption_fixture_config()["prefix_length"], 12, 32
    rng = np.random.default_rng(21)
    tokens = np.zeros((len(records), S), np.int64)
    mask = np.zeros((len(records), P + S), np.float32)
    mask[:, :P] = 1.0
    prefix = np.zeros((len(records), E), np.float32)
    for i, rec in enumerate(records):
        ids = tok.encode(rec["caption"])[:S]
        tokens[i, :len(ids)] = ids
        mask[i, P:P + len(ids)] = 1.0
        prefix[i, (i % 4) * 8:(i % 4 + 1) * 8] = 1.0
        prefix[i] += 0.05 * rng.standard_normal(E).astype(np.float32)
    return {"tokens": tokens, "mask": mask, "prefix": prefix}


def replay_caption_train_fixture(device="cuda") -> dict:
    """The recorded captioner runs through the port's
    ``make_caption_train_step`` on ``device``: {"full" | "only_prefix":
    {"losses", "checksums"}}."""
    from zs_aac_tpu_torch.models.caption import CaptionConfig
    from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params
    from zs_aac_tpu_torch.models.gpt2 import GPT2Config
    from zs_aac_tpu_torch.train.caption_trainer import (CaptionTrainState,
                                                        make_caption_optimizer,
                                                        make_caption_train_step, tensor_tree)
    from zs_aac_tpu_torch.train.optim import linear_warmup_lr
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    fields = caption_fixture_config()
    gpt2 = GPT2Config(**fields.pop("gpt2"))
    o = CAPTION_TRAIN_OPTIM
    batch = caption_train_batch()
    out = {}
    for name, only_prefix in (("full", False), ("only_prefix", True)):
        cfg = CaptionConfig(**fields, only_prefix=only_prefix, gpt2=gpt2)
        params = from_jax_params(load_params(str(FIXTURE_DIR / "best.pth")), device=device)
        opt = make_caption_optimizer(cfg, linear_warmup_lr(o["lr"], o["warmup"],
                                                           CAPTION_TRAIN_STEPS + 1),
                                     o["weight_decay"])
        state = CaptionTrainState(params, opt.init(tensor_tree(params)), 0)
        step = make_caption_train_step(cfg, opt, noise_variance=0.0, device=device)
        losses = []
        for _ in range(CAPTION_TRAIN_STEPS):
            state, loss = step(state, batch, 0)
            losses.append(float(loss))
        out[name] = {"losses": losses, "checksums": checksums(to_jax_params(state.params))}
    return out


def train_fixture_errors(got: dict, want: dict) -> dict:
    """Largest relative differences of a replay from the recorded run:
    losses, checksums (each relative to the leaf's sum of |x|, or of x^2)
    and, where the run records them, batch statistics (relative to the
    largest recorded one)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    assert sorted(got["checksums"]) == sorted(want["checksums"]), "parameter trees differ"
    leaf = 0.0
    for k, w in want["checksums"].items():
        g = got["checksums"][k]
        scale = (w[1], w[1], w[2], w[1])
        leaf = max(leaf, max(abs(a - b) / max(s, 1e-12) for a, b, s in zip(g, w, scale)))
    if "batch_stats" not in want:
        return {"loss": loss, "params": leaf}
    stats = 0.0
    for k, w in want["batch_stats"].items():
        w = np.asarray(w)
        d = np.abs(np.asarray(got["batch_stats"][k]) - w).max()
        stats = max(stats, float(d / np.abs(w).max()))
    return {"loss": loss, "params": leaf, "batch_stats": stats}


def write_word_bpe_model(path, words, chars=""):
    """Write a SentencePiece BPE ``.model`` in which each word (after the
    ``▁`` word-start mark) merges into one piece by the chain of its
    prefixes, shorter merges first; single characters of the words and of
    ``chars`` are pieces, with the 256 byte pieces as fallback for any other
    character. Returns the tokenizer read back from ``path``."""
    from zs_aac_tpu_torch.data.sentencepiece import (BPE, BYTE, CONTROL, NORMAL, UNKNOWN,
                                                     SentencePieceTokenizer, write_model)

    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    seen = set()

    def add(piece, score):
        if piece not in seen:
            seen.add(piece)
            pieces.append((piece, score, NORMAL))

    for w in sorted(set(words)):
        w = "▁" + w
        for k in range(2, len(w) + 1):
            add(w[:k], -float(k))
    for ch in sorted(set("".join(words) + chars + "▁")):
        add(ch, -100.0)
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    write_model(str(path), pieces, model_type=BPE)
    return SentencePieceTokenizer.from_file(str(path))


def stage_tiny_mistral(dst) -> dict:
    """Copy the Mistral fixture into ``dst`` with the run's recorded paths
    (banks, tokenizer, base) pointed at the copy. Returns {"run_dir",
    "test_bank", "train_bank", "tokenizer", "base", "expected"}."""
    dst = Path(dst)
    run = dst / "run"
    run.mkdir(parents=True, exist_ok=True)
    for name in ("train.pkl", "test.pkl", "spm.model", "base.msgpack"):
        shutil.copy(TINY_MISTRAL_DIR / name, dst / name)
    shutil.copy(TINY_MISTRAL_DIR / "run" / "best.pth", run / "best.pth")
    params = json.loads((TINY_MISTRAL_DIR / "run" / "params.json").read_text())
    params.update(data=[str(dst / "train.pkl")], valdata=str(dst / "test.pkl"),
                  tokenizer=str(dst / "spm.model"), mistral_ckpt=str(dst / "base.msgpack"))
    (run / "params.json").write_text(json.dumps(params))
    return {"run_dir": str(run), "test_bank": str(dst / "test.pkl"),
            "train_bank": str(dst / "train.pkl"), "tokenizer": str(dst / "spm.model"),
            "base": str(dst / "base.msgpack"),
            "expected": json.loads((TINY_MISTRAL_DIR / "expected.json").read_text())}


def mistral_fixture_config() -> dict:
    """The tiny Mistral captioner's ``MistralCaptionConfig`` fields (its
    ``params.json``), with its ``MistralConfig``'s under "mistral"."""
    saved = json.loads((TINY_MISTRAL_DIR / "run" / "params.json").read_text())
    return {"prefix_length": saved["prefix_length"], "prefix_size": saved["prefix_dim"],
            "clip_length": saved["prefix_length_clip"], "num_layers": saved["num_layers"],
            "mapping_type": saved["mapping_type"], "islang": saved["islang"],
            "max_seq_len": saved["max_seq_len"], "lora_r": saved["lora_r"],
            "lora_alpha": saved["lora_alpha"],
            "mistral": {"vocab_size": saved["mistral_vocab_size"], "hidden_size": 32,
                        "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "intermediate_size": 64,
                        "sliding_window": 128, "max_positions": 128}}


def mistral_train_batch() -> dict:
    """The recorded LoRA batch (numpy): the training bank's first 8
    records, captions in turn English, Chinese and French behind their tag
    (the fixture's SentencePiece model, "." appended, padded to 16 tokens
    behind ``prefix_length`` mask ones), each with its bank text embedding."""
    import pickle

    from zs_aac_tpu_torch.data.sentencepiece import SentencePieceTokenizer

    tok = SentencePieceTokenizer.from_file(str(TINY_MISTRAL_DIR / "spm.model"))
    with open(TINY_MISTRAL_DIR / "train.pkl", "rb") as f:
        records = pickle.load(f)[:8]
    P, S = mistral_fixture_config()["prefix_length"], 16
    tokens = np.zeros((len(records), S), np.int64)
    mask = np.zeros((len(records), P + S), np.float32)
    mask[:, :P] = 1.0
    for i, rec in enumerate(records):
        tag, cap = [("<en>", rec["caption"]), ("<zh>", rec["cn_caption"]),
                    ("<fr>", rec["fr_caption"])][i % 3]
        ids = tok.encode(f"{tag}{cap}.")[:S]
        tokens[i, :len(ids)] = ids
        mask[i, P:P + len(ids)] = 1.0
    prefix = np.stack([np.asarray(r["text_embedding"], np.float32).reshape(-1)
                       for r in records])
    return {"tokens": tokens, "mask": mask, "prefix": prefix}


def replay_mistral_train_fixture(device="cuda") -> dict:
    """The recorded LoRA run through the port's
    ``make_multilingual_train_step`` on ``device`` (fp32, the fixture's base
    and ``best.pth``): {"losses", "checksums"} of {"mapper", "lora"}."""
    from zs_aac_tpu_torch.models.caption_mistral import MistralCaptionConfig
    from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params
    from zs_aac_tpu_torch.models.mistral import MistralConfig
    from zs_aac_tpu_torch.train.caption_trainer import tensor_tree
    from zs_aac_tpu_torch.train.train_prompt_multilingual import (MultilingualTrainState,
                                                                  load_mistral_base,
                                                                  make_multilingual_optimizer,
                                                                  make_multilingual_train_step)
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    fields = mistral_fixture_config()
    cfg = MistralCaptionConfig(**{**fields, "mistral": MistralConfig(**fields["mistral"])})
    head = from_jax_params(load_params(str(TINY_MISTRAL_DIR / "run" / "best.pth")),
                           device=device)
    params = {**head, "mistral": load_mistral_base(str(TINY_MISTRAL_DIR / "base.msgpack"),
                                                   device)}
    o = MISTRAL_TRAIN_OPTIM
    opt = make_multilingual_optimizer(o["lr"], o["weight_decay"])
    state = MultilingualTrainState(params, opt.init(tensor_tree(params)), 0)
    step = make_multilingual_train_step(cfg, opt, 0.0, device)
    batch = mistral_train_batch()
    losses = []
    for _ in range(MISTRAL_TRAIN_STEPS):
        state, loss = step(state, batch, 0)
        losses.append(float(loss))
    tree = to_jax_params({"mapper": state.params["mapper"], "lora": state.params["lora"]})
    return {"losses": losses, "checksums": checksums(tree)}
