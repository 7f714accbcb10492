"""Committed test fixtures.

``tiny_captioner/``: a converged tiny captioner made by the JAX package's
CLIs (``tests/test_torch_predict.py`` regenerates it with
``PYTHONPATH=. python tests/test_torch_predict.py --write-fixture``).

``tiny_captioner/`` holds the run dir's ``params.json`` and ``best.pth``, the
training bank's captions (``train.pkl``, from which the word tokenizer is
rebuilt), the test bank (``test.pkl``) and ``expected.json``: the captions
the JAX package's ``predict_prompt`` wrote for the test bank, greedy float
and ``--q8``.

``tiny_ase/``: a tiny CLAP model for the encode half (``tests/
test_torch_extract.py --write-fixture`` regenerates it): ``ase.pt``, a
reference-layout state dict (HTSAT at the tiny geometry of
``tests/test_htsat.py`` plus a 2-layer BERT), ``vocab.txt``, four 16-bit
44.1 kHz WAVs under ``audio/`` with ``wav.csv`` and ``text.json``,
``config.json`` (the extract config) and ``expected.json``: the bank records
the JAX package's ``extract_audio_text_bank`` wrote for them.
"""

from __future__ import annotations

import csv
import json
import shutil
from pathlib import Path

__all__ = ["FIXTURE_DIR", "TINY_ASE_DIR", "stage_tiny_captioner", "stage_tiny_ase"]

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
