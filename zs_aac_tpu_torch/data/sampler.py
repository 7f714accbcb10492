"""Duration-bucketed batch sampling.

The port's copy of the JAX package's ``data/sampler.py`` (the reference
``retrieval/data_handling/sampler.py``):
``BySequenceLengthSampler`` (np.linspace buckets, shuffle within bucket,
drop remainder, shuffle batch order) and the passthrough
``BySequenceBatchSampler``. The SpeechBrain-derived ``DynamicBatchSampler``
(lognormal quantile boundaries) is provided as
``dynamic_bucket_boundaries`` + the same sampler.

``bucket_pad_length`` maps a bucket to one padded sample count, so every
batch from a bucket has one shape (the JAX package's static-shape collate,
kept so that both packages give the same batches for a seed).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

__all__ = [
    "BySequenceLengthSampler",
    "BySequenceBatchSampler",
    "dynamic_bucket_boundaries",
    "bucket_pad_length",
]


class BySequenceLengthSampler:
    """Yields batches of indices whose durations fall in the same bucket."""

    def __init__(self, lengths: Sequence[float], bucket_boundaries=(5, 30, 6),
                 batch_size: int = 64, drop_last: bool = True, seed: int = 20):
        self.ind_n_len = list(enumerate(lengths))
        self.bucket_boundaries = np.linspace(*bucket_boundaries)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.random_state = np.random.RandomState(seed)

    def element_to_bucket_id(self, seq_length: float) -> int:
        b = list(self.bucket_boundaries)
        lo = [np.iinfo(np.int32).min] + b
        hi = b + [np.iinfo(np.int32).max]
        cond = np.logical_and(np.less_equal(lo, seq_length), np.less(seq_length, hi))
        return int(np.min(np.where(cond)))

    def __iter__(self) -> Iterator[List[int]]:
        buckets: dict = {}
        for i, length in self.ind_n_len:
            buckets.setdefault(self.element_to_bucket_id(length), []).append(i)
        batches = []
        for k, items in buckets.items():
            arr = np.asarray(items)
            self.random_state.shuffle(arr)
            n_full = len(arr) // self.batch_size
            for j in range(n_full):
                batches.append(arr[j * self.batch_size : (j + 1) * self.batch_size])
            rem = arr[n_full * self.batch_size :]
            if len(rem) and not self.drop_last:
                batches.append(rem)
        self.random_state.shuffle(batches)
        for b in batches:
            yield list(map(int, b))

    def __len__(self) -> int:
        return len(self.ind_n_len)


class BySequenceBatchSampler:
    """Passthrough batch sampler (sampler.py:365-378)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler) // self.batch_size
        return n if self.drop_last else n + 1

    def __iter__(self):
        yield from self.sampler


def dynamic_bucket_boundaries(
    max_batch_length: float, num_buckets: int, shape: float = 1.0,
    scale: float = 1.0, loc: float = 0.0,
) -> np.ndarray:
    """Lognormal-quantile bucket boundaries (the reference's unused
    SpeechBrain-derived DynamicBatchSampler, sampler.py:19-300)."""
    from scipy.stats import lognorm

    qs = np.linspace(0, 1, num_buckets + 1)[1:-1]
    bounds = lognorm.ppf(qs, s=shape, scale=scale * max_batch_length, loc=loc)
    return np.clip(bounds, 0, max_batch_length)


def bucket_pad_length(duration: float, bucket_boundaries=(5, 30, 6), sr: int = 32000) -> int:
    """Static padded sample count for a clip: the upper edge of its bucket."""
    edges = np.linspace(*bucket_boundaries)
    for e in edges:
        if duration <= e:
            return int(e * sr)
    return int(edges[-1] * sr)
