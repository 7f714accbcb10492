"""Committed test fixtures.

``tiny_captioner/``: a converged tiny captioner made by the JAX package's
CLIs (``tests/test_torch_predict.py`` regenerates it with
``PYTHONPATH=. python tests/test_torch_predict.py --write-fixture``).

``tiny_captioner/`` holds the run dir's ``params.json`` and ``best.pth``, the
training bank's captions (``train.pkl``, from which the word tokenizer is
rebuilt), the test bank (``test.pkl``) and ``expected.json``: the captions
the JAX package's ``predict_prompt`` wrote for the test bank, greedy float
and ``--q8`` and beam (``--isbeam``) float and ``--q8``.

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
"""

from __future__ import annotations

import csv
import json
import shutil
from pathlib import Path

import numpy as np

__all__ = ["FIXTURE_DIR", "TINY_ASE_DIR", "stage_tiny_captioner", "stage_tiny_ase",
           "train_batch", "checksums", "TRAIN_STEPS", "TRAIN_OPTIM"]

# the recorded train run: Adam under a clip of the global norm at 2, cosine
# schedule with one warmup step over TRAIN_STEPS steps
TRAIN_STEPS = 3
TRAIN_OPTIM = {"lr": 1e-3, "warmup": 1, "clip": 2.0, "optimizer": "adam"}

FIXTURE_DIR = Path(__file__).resolve().parent / "tiny_captioner"
TINY_ASE_DIR = Path(__file__).resolve().parent / "tiny_ase"


def stage_tiny_captioner(dst) -> dict:
    """Copy the fixture into ``dst`` as a run dir plus banks, with the
    recorded training-bank path pointed at the copy. Returns {"run_dir",
    "test_bank", "expected"}."""
    dst = Path(dst)
    run = dst / "run"
    run.mkdir(parents=True, exist_ok=True)
    for name in ("train.pkl", "test.pkl"):
        shutil.copy(FIXTURE_DIR / name, dst / name)
    shutil.copy(FIXTURE_DIR / "best.pth", run / "best.pth")
    params = json.loads((FIXTURE_DIR / "params.json").read_text())
    params["data"] = [str(dst / "train.pkl")]
    (run / "params.json").write_text(json.dumps(params))
    return {"run_dir": str(run), "test_bank": str(dst / "test.pkl"),
            "expected": json.loads((FIXTURE_DIR / "expected.json").read_text())}


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


def train_fixture_errors(got: dict, want: dict) -> dict:
    """Largest relative differences of a replay from the recorded run:
    losses, checksums (each relative to the leaf's sum of |x|, or of x^2)
    and batch statistics (relative to the largest recorded one)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    assert sorted(got["checksums"]) == sorted(want["checksums"]), "parameter trees differ"
    leaf = 0.0
    for k, w in want["checksums"].items():
        g = got["checksums"][k]
        scale = (w[1], w[1], w[2], w[1])
        leaf = max(leaf, max(abs(a - b) / max(s, 1e-12) for a, b, s in zip(g, w, scale)))
    stats = 0.0
    for k, w in want["batch_stats"].items():
        w = np.asarray(w)
        d = np.abs(np.asarray(got["batch_stats"][k]) - w).max()
        stats = max(stats, float(d / np.abs(w).max()))
    return {"loss": loss, "params": leaf, "batch_stats": stats}
