"""Audio-text retrieval metrics (recall@k, medr/meanr, mAP10).

The port's copy of the JAX package's ``eval/retrieval.py`` (the reference
``retrieval/tools/utils.py`` ``a2t``/``t2a``, which assume 5 captions per
audio): both directions from one similarity matmul and vectorized rank
arithmetic, in numpy.

Embeddings are L2-normalized by the ASE encoders, so the dot product *is*
the cosine similarity.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["a2t", "t2a"]


def _sims(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a @ b.T


def a2t(audio_embs: np.ndarray, cap_embs: np.ndarray) -> Dict[str, float]:
    """Audio->text. Row layout: 5 caption rows (and 5 duplicated audio rows)
    per audio, like the reference."""
    audio_embs = np.asarray(audio_embs)
    cap_embs = np.asarray(cap_embs)
    num_audios = audio_embs.shape[0] // 5
    audios = audio_embs[::5]

    d = _sims(audios, cap_embs)  # [A, 5A]
    order = np.argsort(-d, axis=1)
    # position of each caption column in each row's ranking
    pos = np.empty_like(order)
    rows = np.arange(num_audios)[:, None]
    pos[rows, order] = np.arange(d.shape[1])[None, :]

    gt = 5 * np.arange(num_audios)[:, None] + np.arange(5)[None, :]
    gt_pos = pos[rows, gt]  # [A, 5]
    ranks = gt_pos.min(axis=1)

    ap10 = np.zeros(num_audios)
    for i in range(num_audios):
        hits = np.sort(gt_pos[i][gt_pos[i] < 10]) + 1
        if hits.size:
            ap10[i] = np.sum(np.arange(1, hits.size + 1) / hits) / 5
    return _pack(ranks, 100.0 * ap10.mean())


def t2a(audio_embs: np.ndarray, cap_embs: np.ndarray) -> Dict[str, float]:
    """Text->audio."""
    audio_embs = np.asarray(audio_embs)
    cap_embs = np.asarray(cap_embs)
    num_audios = audio_embs.shape[0] // 5
    audios = audio_embs[::5]

    d = _sims(cap_embs, audios)  # [5A, A]
    target = np.repeat(np.arange(num_audios), 5)
    # rank of the target audio for each caption = #audios scored higher
    target_scores = d[np.arange(d.shape[0]), target][:, None]
    ranks = np.sum(d > target_scores, axis=1)

    top10 = ranks < 10
    map10 = 100.0 * np.sum(1.0 / (ranks[top10] + 1)) / len(ranks)
    return _pack(ranks, map10)


def _pack(ranks: np.ndarray, map10: float) -> Dict[str, float]:
    n = len(ranks)
    return {
        "r1": 100.0 * np.sum(ranks < 1) / n,
        "r5": 100.0 * np.sum(ranks < 5) / n,
        "r10": 100.0 * np.sum(ranks < 10) / n,
        "r50": 100.0 * np.sum(ranks < 50) / n,
        "medr": float(np.floor(np.median(ranks)) + 1),
        "meanr": float(ranks.mean() + 1),
        "mAP10": float(map10),
    }
