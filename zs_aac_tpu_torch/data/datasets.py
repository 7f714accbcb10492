"""Caption datasets over embedding banks.

The port's copy of the JAX package's ``data/datasets.py``, host code with the
same ``random.Random`` and ``np.random.default_rng`` calls in the same order,
so items and batches are those of the JAX package bit for bit:

- ``CaptionBankDataset`` (training): the prefix is the record's
  ``audio_embedding``, a random row of its ``related_embeddings`` or its
  ``text_embedding``; streamed records are kept at 8-20 caption words,
  records of a pickled list unfiltered; ``percentage`` <= 1 is a fraction,
  > 1 a count; captions end in '.', are padded or cut to ``max_seq_len`` with
  a mask behind ``prefix_length`` ones; optional AudioSet hard prompts
  ("There are a, b, c in this audio.") with ``mask_probability``; the
  multilingual pick among en/zh/fr captions with language tags;
- ``caption_batches``: fixed-shape numpy batches, hard prompts padded to
  ``max_hard_len``;
- ``CaptionBankTestDataset``: audio embeddings and reference captions per
  clip, with optional hard prompts.
"""

from __future__ import annotations

import dataclasses
import pickle
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from zs_aac_tpu_torch.data.banks import read_label_bank
from zs_aac_tpu_torch.data.prompts import compose_discrete_prompts, entities_process

__all__ = ["CaptionDatasetConfig", "CaptionBankDataset", "CaptionBankTestDataset",
           "caption_batches", "compose_discrete_prompts"]


@dataclasses.dataclass
class CaptionDatasetConfig:
    prefix_length: int = 10
    max_seq_len: int = 25
    normalize_prefix: bool = False
    use_audio_embedding: bool = False
    use_related_text: bool = False
    percentage: float = 1.0
    word_filter: tuple = (8, 20)
    sound_effect_path: Optional[str] = None
    sound_effect_k: int = 3
    mask_probability: float = 0.0
    max_hard_len: int = 20
    multilingual: bool = False
    lang_tags: tuple = ("<en>", "<zh>", "<fr>")
    lang_offset: int = 0  # tokens of the language tag prefix
    seed: int = 0


def _load_records(paths: Sequence[str], word_filter) -> List[dict]:
    lo, hi = word_filter
    out: List[dict] = []
    for p in paths:
        with open(p, "rb") as f:
            while True:
                try:
                    item = pickle.load(f)
                except EOFError:
                    break
                if isinstance(item, list):
                    out.extend(item)  # list banks bypass the filter
                else:
                    n = len(item["caption"].split())
                    if lo <= n <= hi:
                        out.append(item)
    return out


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class CaptionBankDataset:
    """Training dataset over embedding banks."""

    def __init__(self, data_paths: Sequence[str], tokenizer, cfg: CaptionDatasetConfig):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rng = random.Random(cfg.seed)
        records = _load_records(data_paths, cfg.word_filter)
        if cfg.percentage <= 1.0:
            k = int(cfg.percentage * len(records))
        else:
            k = int(cfg.percentage)
        self.records = self.rng.sample(records, k) if k < len(records) else records

        self.labels = self.label_embeddings = None
        if cfg.sound_effect_path:
            self.labels, self.label_embeddings = read_label_bank(cfg.sound_effect_path)
            self.label_embeddings = _normalize(self.label_embeddings)

    def __len__(self) -> int:
        return len(self.records)

    def pad_tokens(self, caption: str):
        if not caption.endswith("."):
            caption = caption + "."
        ids = np.asarray(self.tokenizer.encode(caption), np.int64)
        S = self.cfg.max_seq_len
        tokens = np.zeros(S, np.int64)
        L = min(len(ids), S)
        tokens[:L] = ids[:L]
        tok_mask = np.zeros(S, np.float32)
        tok_mask[:L] = 1.0
        mask = np.concatenate([np.ones(self.cfg.prefix_length, np.float32), tok_mask])
        return tokens, mask

    def _caption_of(self, rec: dict) -> str:
        if not self.cfg.multilingual:
            return rec["caption"]
        options = [(self.cfg.lang_tags[0], rec["caption"])]
        if rec.get("cn_caption"):
            options.append((self.cfg.lang_tags[1], rec["cn_caption"]))
        if rec.get("fr_caption"):
            options.append((self.cfg.lang_tags[2], rec["fr_caption"]))
        tag, cap = self.rng.choice(options)
        return f"{tag}{cap}"

    def _prefix_of(self, rec: dict) -> np.ndarray:
        c = self.cfg
        if c.use_audio_embedding:
            p = np.asarray(rec["audio_embedding"], np.float32)
        elif c.use_related_text:
            rel = np.asarray(rec["related_embeddings"], np.float32)
            p = rel[self.rng.randrange(rel.shape[0])]
        else:
            p = np.asarray(rec["text_embedding"], np.float32)
        p = p.reshape(-1)
        return _normalize(p) if c.normalize_prefix else p

    def hard_prompt_of(self, prefix: np.ndarray) -> Optional[np.ndarray]:
        if self.label_embeddings is None:
            return None
        sims = _normalize(prefix[None]) @ self.label_embeddings.T
        topk = np.argsort(-sims[0])[: self.cfg.sound_effect_k]
        ents = entities_process(
            [self.labels[i] for i in topk], self.cfg.mask_probability, self.rng
        )
        return compose_discrete_prompts(self.tokenizer, ents)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        tokens, mask = self.pad_tokens(self._caption_of(rec))
        prefix = self._prefix_of(rec)
        item = {"tokens": tokens, "mask": mask, "prefix": prefix}
        hp = self.hard_prompt_of(prefix)
        if hp is not None:
            item["hard_prompt"] = hp
        return item


class CaptionBankTestDataset:
    """Test dataset: audio embeddings + reference captions per clip."""

    def __init__(self, data_path: str, tokenizer=None,
                 cfg: Optional[CaptionDatasetConfig] = None):
        self.cfg = cfg or CaptionDatasetConfig()
        self.tokenizer = tokenizer
        with open(data_path, "rb") as f:
            self.records = pickle.load(f)
        self.labels = self.label_embeddings = None
        if self.cfg.sound_effect_path:
            self.labels, self.label_embeddings = read_label_bank(
                self.cfg.sound_effect_path
            )
            self.label_embeddings = _normalize(self.label_embeddings)

    def __len__(self) -> int:
        return len(self.records)

    def references(self) -> Dict[str, List[str]]:
        """key2refs: lowercased captions per audio_id."""
        out = {}
        for rec in self.records:
            caps = rec["caption"]
            if isinstance(caps, list):
                out[rec["audio_id"]] = [str(c["caption"]).lower() for c in caps]
            else:
                out[rec["audio_id"]] = [str(caps).lower()]
        return out

    def __getitem__(self, i: int):
        rec = self.records[i]
        prefix = np.asarray(rec["audio_embedding"], np.float32).reshape(-1)
        if self.cfg.normalize_prefix:
            prefix = _normalize(prefix)
        item = {"audio_id": rec["audio_id"], "prefix": prefix}
        if self.label_embeddings is not None:
            sims = _normalize(prefix[None]) @ self.label_embeddings.T
            topk = np.argsort(-sims[0])[: self.cfg.sound_effect_k]
            item["hard_prompt"] = compose_discrete_prompts(
                self.tokenizer, [self.labels[j] for j in topk]
            )
        return item


def caption_batches(
    dataset: CaptionBankDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
):
    """Yield fixed-shape numpy batches for the train step."""
    idx = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    H = dataset.cfg.max_hard_len
    for s in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
        sel = idx[s : s + batch_size]
        if len(sel) < batch_size and drop_last:
            break
        items = [dataset[int(i)] for i in sel]
        batch = {
            "tokens": np.stack([it["tokens"] for it in items]),
            "mask": np.stack([it["mask"] for it in items]),
            "prefix": np.stack([it["prefix"] for it in items]),
        }
        if "hard_prompt" in items[0]:
            hp = np.zeros((len(items), H), np.int64)
            hm = np.zeros((len(items), H), np.float32)
            for i, it in enumerate(items):
                h = it["hard_prompt"][:H]
                hp[i, : len(h)] = h
                hm[i, : len(h)] = 1.0
            batch["hard_prompt"] = hp
            batch["hard_mask"] = hm
        yield batch
