"""Zero-shot audio classification (CLI).

The counterpart of the JAX package's ``eval/zero_shot.py`` (the reference's
``retrieval/zero_shot_classification.py``): class names become text prompts,
each clip is padded or cut to 10 s and encoded, the prediction is the argmax
of audio @ text.T, and the per-fold and mean accuracies are printed as
"Fold k Accuracy a" and "<dataset> Accuracy m". Two layouts under
``--data_root``:

- ``urbansound8k``: ``UrbanSound8K/metadata/UrbanSound8K.csv`` (columns
  ``slice_file_name``, ``fold``, ``classID``, ``class``), clips under
  ``UrbanSound8K/audio/fold<k>/``, 10 folds, the class names with "_"
  replaced by a space;
- ``esc50``: ``ESC-50/meta/esc50.csv`` (``filename``, ``fold``, ``target``,
  ``category``), clips under ``ESC-50/audio/``, 5 folds, the prompt
  "<category> can be heard".

Classes are listed in the order of their ids, as the JAX package sorts the
table by id. Similarities and the argmax are fp32 numpy, so a tie goes to
the lower class id. Where the port differs:

- The CSVs are read with the ``csv`` module (no pandas), and a fold's rows
  are taken in the table's order sorted stably by class id; in eval mode each
  clip's embedding is independent of the others in its batch, so the order
  changes no accuracy.
- ``-c`` is read by ``utils.config.load_config`` (no pyyaml);
  ``zero_shot(config, ...)`` takes the config as a dict.
- ``--device`` (default ``cuda``; raises without CUDA) as in the port's other
  CLIs. On the card every audio encode runs kernel K2 (the log-mel), then the
  config's tower.
- ``--ckpt`` is read by ``utils.checkpoints.load_ase_variables``: a train
  state of the port's training drivers or a reference-layout ``.pt``
  checkpoint; a JAX-package orbax train state is converted first by
  ``examples/convert_jax_state.py`` (a directory raises an error naming
  it). The
  weights are cast to bf16 where the config's ``compute_dtype`` is
  ``bfloat16``, as ``build_ase_from_config`` builds the model.

Run: ``python -m zs_aac_tpu_torch.eval.zero_shot -c configs/inference.yaml
--ckpt CKPT --dataset esc50 --data_root DIR``.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["classify", "zero_shot", "main", "DATASETS"]

# dataset -> (csv path, file column, id column, class column, folds, prompt,
# audio path of (fold, file name)) under the data root
DATASETS = {
    "urbansound8k": ("UrbanSound8K/metadata/UrbanSound8K.csv", "slice_file_name", "classID",
                     "class", 10, "{}", lambda fold, name: f"UrbanSound8K/audio/fold{fold}/{name}"),
    "esc50": ("ESC-50/meta/esc50.csv", "filename", "target", "category", 5, "{} can be heard",
              lambda fold, name: f"ESC-50/audio/{name}"),
}


def classify(encode_audio: Callable, text_embeds: np.ndarray, wave_batches,
             predictions: Optional[list] = None) -> float:
    """Mean accuracy of the argmax of audio-text similarity. ``encode_audio``
    maps waves [B, T] to embeddings [B, E] (numpy); ``wave_batches`` yields
    (waves, labels); ``predictions``, where given, is extended with each
    batch's predicted class ids."""
    text_embeds = np.asarray(text_embeds, np.float32)
    correct = total = 0
    for waves, labels in wave_batches:
        emb = np.asarray(encode_audio(waves), np.float32)
        pred = (emb @ text_embeds.T).argmax(axis=1)
        if predictions is not None:
            predictions.extend(pred.tolist())
        correct += int((pred == np.asarray(labels)).sum())
        total += len(labels)
    return correct / max(total, 1)


def _batched(paths: Sequence[str], labels: Sequence[int], batch: int, sr: int,
             pad_seconds: int = 10):
    """(waves [b, pad_seconds * sr] float32, labels [b]) per ``batch`` clips."""
    from zs_aac_tpu_torch.data.audio_io import load_audio, pad_or_truncate

    n = pad_seconds * sr
    for s in range(0, len(paths), batch):
        sel = slice(s, s + batch)
        waves = np.stack([pad_or_truncate(load_audio(p, sr), n) for p in paths[sel]])
        yield waves, np.asarray(labels[sel])


def _table(data_root: str, dataset: str):
    """(class prompts in id order, {fold: (paths, labels)})."""
    table, file_col, id_col, cls_col, n_folds, prompt, audio = DATASETS[dataset]
    with open(os.path.join(data_root, table), newline="") as f:
        rows = sorted(csv.DictReader(f), key=lambda r: int(r[id_col]))
    classes: List[str] = []
    for r in rows:
        name = prompt.format(r[cls_col].replace("_", " "))
        if name not in classes:
            classes.append(name)
    folds = {}
    for fold in range(1, n_folds + 1):
        sel = [r for r in rows if int(r["fold"]) == fold]
        folds[fold] = ([os.path.join(data_root, audio(fold, r[file_col])) for r in sel],
                       [int(r[id_col]) for r in sel])
    return classes, folds


def zero_shot(config: dict, variables: dict, dataset: str, data_root: str, *, batch: int = 16,
              device="cuda", predictions: Optional[dict] = None) -> dict:
    """Per-fold and mean accuracy of the ASE ``variables`` built from
    ``config`` (its ``audio_args``, ``text_encoder_args.vocab`` and model
    keys, as the pretrain driver reads them) on ``dataset`` under
    ``data_root``; prints the JAX package's lines. ``predictions``, where
    given, receives each fold's predicted class ids. Returns {"folds": [...],
    "mean": m}."""
    import torch

    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import make_encode_fns
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    tokenizer = WordPieceTokenizer.from_file(config["text_encoder_args"]["vocab"])
    ase, _ = build_ase_from_config(config, device=dev)
    mel_cfg = LogMelConfig.from_dict(config["audio_args"])
    enc_a, enc_t = make_encode_fns(ase, mel_cfg, device=dev)
    classes, folds = _table(data_root, dataset)
    ids, mask = tokenizer.batch_encode(classes, max_length=30)
    text_embeds = enc_t(variables, torch.from_numpy(ids), torch.from_numpy(mask))
    text_embeds = text_embeds.float().cpu().numpy()
    encode = lambda w: enc_a(variables, torch.from_numpy(w)).float().cpu().numpy()

    accs = []
    for fold, (paths, labels) in folds.items():
        pred = [] if predictions is not None else None
        acc = classify(encode, text_embeds, _batched(paths, labels, batch,
                                                     config["audio_args"]["sr"]), pred)
        if predictions is not None:
            predictions[fold] = pred
        print(f"Fold {fold} Accuracy {acc}")
        accs.append(acc)
    print(f"{dataset} Accuracy {np.mean(accs)}")
    return {"folds": accs, "mean": float(np.mean(accs))}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True, help="ASE checkpoint (a port train state or a "
                                                 "reference-layout .pt)")
    p.add_argument("--dataset", choices=sorted(DATASETS), default="urbansound8k")
    p.add_argument("--data_root", default="data")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from zs_aac_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    import torch

    from zs_aac_tpu_torch.models.convert import cast_floating
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config
    from zs_aac_tpu_torch.utils.checkpoints import load_ase_variables
    from zs_aac_tpu_torch.utils.config import load_config

    config = load_config(args.config)
    _, cfg = build_ase_from_config(config, device=dev)
    variables = load_ase_variables(args.ckpt, cfg, device=dev)
    if cfg.dtype == torch.bfloat16:
        variables = cast_floating(variables, torch.bfloat16)
    return zero_shot(config, variables, args.dataset, args.data_root, batch=args.batch,
                     device=dev)["mean"]


if __name__ == "__main__":
    main()
