"""Embedding banks: the reference's two pickle formats, read and written.

A bank is either one pickled list of record dicts, or records appended with
``pickle.dump`` and read until ``EOFError`` (streamed). Record keys:
``audio_embedding`` [1, E] fp32, ``text_embedding`` [1, E], ``caption`` (a
string, or a list of dicts in test banks), ``audio_id``. Label banks hold
{label, label_embedding [1, E], label_id} records. A columnar ``.npz``
(``save_bank_npz`` / ``load_bank_npz``) holds the same records in one file.
"""

from __future__ import annotations

import pickle
from typing import Dict, Iterable, Iterator, List

import numpy as np

__all__ = ["iter_bank", "read_bank", "read_label_bank", "write_bank_stream", "write_bank_list",
           "save_bank_npz", "load_bank_npz"]


def iter_bank(path: str) -> Iterator[dict]:
    """Yield records from either pickle format (list or streamed)."""
    with open(path, "rb") as f:
        while True:
            try:
                item = pickle.load(f)
            except EOFError:
                return
            if isinstance(item, list):
                yield from item
            else:
                yield item


def read_bank(path: str) -> List[dict]:
    return list(iter_bank(path))


def write_bank_stream(path: str, records: Iterable[dict], append: bool = False) -> int:
    """Streamed writer (appended pickle records, EOFError-terminated)."""
    n = 0
    with open(path, "ab" if append else "wb") as f:
        for rec in records:
            pickle.dump(rec, f)
            n += 1
    return n


def write_bank_list(path: str, records: List[dict]) -> None:
    """Single pickled list (the reference embeddings_generator's format)."""
    with open(path, "wb") as f:
        pickle.dump(records, f)


def read_label_bank(path: str):
    """AudioSet label bank -> (labels [N] str, embeddings [N, E] fp32)."""
    records = read_bank(path)
    labels = [r["label"] for r in records]
    embs = np.concatenate(
        [np.asarray(r["label_embedding"], np.float32).reshape(1, -1) for r in records]
    )
    return labels, embs


def save_bank_npz(path: str, records: List[dict]) -> None:
    """Columnar npz: stacked embeddings + object arrays for text fields."""
    cols: Dict[str, list] = {}
    for rec in records:
        for k, v in rec.items():
            cols.setdefault(k, []).append(v)
    out = {}
    for k, vals in cols.items():
        if isinstance(vals[0], np.ndarray) or hasattr(vals[0], "shape"):
            arrs = [np.asarray(v, np.float32).reshape(-1, np.asarray(v).shape[-1])
                    if np.asarray(v).ndim > 1 else np.asarray(v, np.float32)[None]
                    for v in vals]
            shapes = {a.shape for a in arrs}
            if len(shapes) == 1:
                out[k] = np.stack(arrs)
                continue
        out[k] = np.asarray(vals, dtype=object)
    np.savez(path, **{k: v for k, v in out.items()})


def load_bank_npz(path: str) -> List[dict]:
    data = np.load(path, allow_pickle=True)
    keys = list(data.keys())
    n = len(data[keys[0]])
    return [{k: data[k][i] for k in keys} for i in range(n)]
