"""Embedding banks: the reference's two pickle formats, read and written.

A bank is either one pickled list of record dicts, or records appended with
``pickle.dump`` and read until ``EOFError`` (streamed). Record keys:
``audio_embedding`` [1, E] fp32, ``text_embedding`` [1, E], ``caption`` (a
string, or a list of dicts in test banks), ``audio_id``. Label banks hold
{label, label_embedding [1, E], label_id} records.
"""

from __future__ import annotations

import pickle
from typing import Iterator, List

import numpy as np

__all__ = ["iter_bank", "read_bank", "read_label_bank", "write_bank_list"]


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
