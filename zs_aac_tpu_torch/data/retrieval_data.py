"""Retrieval-side datasets: WavCaps-style pretraining merge + caption sets.

The port's copy of the JAX package's ``data/retrieval_data.py`` (the
reference ``retrieval/data_handling/pretrain_dataset.py``: manifest merge
with per-corpus blacklist filtering, per-item audio load at 32 kHz with
random crop to ``max_length`` seconds, ``text_preprocess``, duration-bucketed
loading; and ``caption_dataset.py``/``datamodule.py``: Clotho/AudioCaps
train/val/test with 5-caption flattening). Batches pad to the bucket's
upper edge, as the JAX package's do, so both give the same batches for a
seed.

Multi-process (``parallel.mesh``; the identity in one process): every
process builds the same global batches from the same seed and loads only
its rows. ``pretrain_batches`` and the data module's ``train_batches`` give
each process its ``local_batch_slice`` of every global batch (the pad
length from the global batch's metadata), so the global batch is the one
one process would train on; the JAX package strides its data module's
training batches over processes as well, which makes its global batch grow
with the process count. ``val_batches``/``test_batches`` give each process
every ``process_count``-th batch, tagged with its global row ids
(``"index"``) for ``allgather_by_index``, as the JAX package's do; their
``max_batches`` caps the global batches before they are strided.
"""

from __future__ import annotations

import json
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from zs_aac_tpu_torch.data.audio_io import load_audio, random_crop
from zs_aac_tpu_torch.data.sampler import BySequenceLengthSampler, bucket_pad_length
from zs_aac_tpu_torch.data.text_transform import text_preprocess
from zs_aac_tpu_torch.parallel.mesh import local_batch_slice, process_count, process_index

__all__ = [
    "load_manifest_files",
    "AudioLanguagePretrainDataset",
    "AudioCaptionDataset",
    "pretrain_batches",
    "AudioCaptionDataModule",
]


def load_manifest_files(files: Sequence[str], blacklist: Optional[str] = None) -> List[dict]:
    """Merge retrieval json manifests, applying the per-corpus blacklist
    (pretrain_dataset.py:17-48). Multi-caption files flatten captions with a
    shared audio id (same-audio captions become contrastive positives)."""
    data: List[dict] = []
    bl = None
    if blacklist is not None:
        with open(blacklist) as f:
            bl = json.load(f)
    audio_id = 0
    for file in files:
        with open(file) as f:
            obj = json.load(f)
        n_cap = obj["num_captions_per_audio"]
        for item in obj["data"]:
            if bl is not None:
                if "FreeSound" in file and item["id"] in bl.get("FreeSound", ()):
                    continue
                if ("AudioSet" in file or "AudioCaps" in file) and item["id"] in bl.get(
                    "AudioSet", ()
                ):
                    continue
                if "Clotho" in file and item["id"] in bl.get("FreeSound", ()):
                    continue
            if n_cap == 1:
                data.append(
                    {"audio": item["audio"], "caption": item["caption"],
                     "id": audio_id, "duration": item["duration"]}
                )
            else:
                for i in range(1, n_cap + 1):
                    data.append(
                        {"audio": item["audio"], "caption": item[f"caption_{i}"],
                         "id": audio_id, "duration": item["duration"]}
                    )
            audio_id += 1
    return data


class AudioLanguagePretrainDataset:
    def __init__(self, json_files: Sequence[str], audio_config: dict,
                 blacklist: Optional[str] = None, seed: int = 0):
        self.json_data = load_manifest_files(json_files, blacklist)
        self.lengths = [item["duration"] for item in self.json_data]
        self.sr = audio_config["sr"]
        self.max_length = audio_config.get("max_length", 0) * self.sr
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.json_data)

    def __getitem__(self, index: int):
        item = self.json_data[index]
        wave = load_audio(item["audio"], self.sr)
        if self.max_length and len(wave) > self.max_length:
            wave = random_crop(wave, self.max_length, self.rng)
        return wave, text_preprocess(item["caption"]), item["id"]


class AudioCaptionDataset:
    """Clotho/AudioCaps caption set; 5 captions flatten to 5 rows
    (caption_dataset.py:15-64)."""

    def __init__(self, audio_config: dict, dataset: str, split: str,
                 data_root: str = "data", seed: int = 0):
        self.sr = audio_config["sr"]
        self.max_length = audio_config.get("max_length", 0) * self.sr
        with open(f"{data_root}/{dataset}/json_files/{split}.json") as f:
            obj = json.load(f)
        self.num_captions_per_audio = obj["num_captions_per_audio"]
        items = obj["data"]
        if self.num_captions_per_audio == 1:
            self.captions = [it["caption"] for it in items]
            self.wav_paths = [it["audio"] for it in items]
        elif self.num_captions_per_audio == 5:
            self.captions = [it[f"caption_{i}"] for it in items for i in range(1, 6)]
            self.wav_paths = [it["audio"] for it in items for _ in range(5)]
        else:
            raise ValueError("Incorrect num_captions_per_audio.")
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, index: int):
        wave = load_audio(self.wav_paths[index], self.sr)
        if self.max_length and len(wave) > self.max_length:
            wave = random_crop(wave, self.max_length, self.rng)
        return wave, text_preprocess(self.captions[index]), index // self.num_captions_per_audio


def _collate(items, tokenizer, text_len: int, pad_samples: Optional[int]) -> Dict:
    waves, texts, ids = zip(*items)
    T = pad_samples or max(len(w) for w in waves)
    over = max((len(w) for w in waves), default=0) - T
    if over > 0:
        # metadata under-reported a clip's duration: the wave is cut at the
        # bucket edge (identically on every host). Surface it — silent
        # truncation would hide bad manifests.
        import logging

        logging.getLogger("zs_aac_tpu_torch.data").warning(
            "collate truncating wave(s) by up to %d samples to the %d-sample "
            "bucket edge (manifest duration under-reports the clip)", over, T
        )
    wav = np.zeros((len(waves), T), np.float32)
    for i, w in enumerate(waves):
        wav[i, : min(len(w), T)] = w[:T]
    input_ids, attention_mask = tokenizer.batch_encode(
        list(texts), max_length=text_len, pad_to_max=True
    )
    return {
        "wave": wav,
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "idx": np.asarray(ids, np.int64),
        "text": list(texts),
    }


def pretrain_batches(
    dataset,
    tokenizer,
    batch_size: int,
    bucket_boundaries=(5, 30, 6),
    text_len: int = 30,
    seed: int = 20,
    static_shapes: bool = True,
) -> Iterator[Dict]:
    """Bucketed batches; each bucket pads to its upper edge (static shapes).

    Each process loads its ``local_batch_slice`` of every global batch. The
    pad length comes from the global batch's bucket (manifest durations),
    so every process's rows have one shape.
    """
    if hasattr(dataset, "lengths"):
        lengths = dataset.lengths
    else:
        # No duration metadata: derive real lengths once up front instead of
        # assuming 30 s for everything (which would pad every batch to the
        # top bucket and silently truncate anything longer than its guess).
        sr = getattr(dataset, "sr", 1)
        lengths = [len(dataset[i][0]) / sr for i in range(len(dataset))]
    sampler = BySequenceLengthSampler(
        lengths, bucket_boundaries, batch_size, drop_last=True, seed=seed,
    )
    for batch_idx in sampler:
        items = [dataset[i] for i in list(batch_idx)[local_batch_slice(len(batch_idx))]]
        pad = None
        if static_shapes:
            # pad from metadata only; a wave longer than its metadata bucket
            # is truncated to the bucket edge by _collate
            d = max(lengths[i] for i in batch_idx)
            pad = bucket_pad_length(d, bucket_boundaries, dataset.sr)
        yield _collate(items, tokenizer, text_len, pad)


class AudioCaptionDataModule:
    """train/val/test loader factory (datamodule.py:17-100)."""

    def __init__(self, config: dict, dataset: str, tokenizer, data_root: str = "data"):
        audio = config["audio_args"]
        self.train_set = AudioCaptionDataset(audio, dataset, "train", data_root)
        self.val_set = AudioCaptionDataset(audio, dataset, "val", data_root)
        self.test_set = AudioCaptionDataset(audio, dataset, "test", data_root)
        self.batch_size = config["data_args"]["batch_size"]
        self.tokenizer = tokenizer
        self.text_len = config.get("text_len", 30)
        self.pad_samples = audio.get("max_length", 30) * audio["sr"]

    def _batches(self, ds, shuffle: bool, seed: int = 0, drop_last: bool = False,
                 max_batches: Optional[int] = None):
        """Training (``drop_last``): this process's rows of every global
        batch. Evaluation: every ``process_count``-th whole batch of the
        first ``max_batches`` (all by default), so a capped evaluation
        covers the same rows at any world size."""
        idx = np.arange(len(ds))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        starts = list(range(0, len(idx) - (self.batch_size - 1 if drop_last else 0),
                            self.batch_size))
        if not drop_last:
            starts = starts[:max_batches or None][process_index()::process_count()]
        for s in starts:
            sel = idx[s : s + self.batch_size]
            if drop_last and len(sel) < self.batch_size:
                continue
            if drop_last:
                sel = sel[local_batch_slice(len(sel))]
            batch = _collate([ds[int(i)] for i in sel], self.tokenizer,
                             self.text_len, self.pad_samples)
            batch["index"] = np.asarray(sel, np.int64)
            yield batch

    def train_batches(self, seed: int = 0):
        return self._batches(self.train_set, True, seed, drop_last=True)

    def val_batches(self, max_batches: Optional[int] = None):
        return self._batches(self.val_set, False, max_batches=max_batches)

    def test_batches(self, max_batches: Optional[int] = None):
        return self._batches(self.test_set, False, max_batches=max_batches)
