"""Hard-prompt composition from detected sound-event entities.

The port's copy of the JAX package's ``data/prompts.py``: ``entities_process``
(random masking), ``compose_discrete_prompts`` ("There are a, b, c in this
audio."), ``parse_entities`` and ``padding_captions`` (pad -> mask -> zero).
Tokenizer-agnostic: anything with ``.encode(str) -> list[int]`` works.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "entities_process",
    "compose_discrete_prompts",
    "parse_entities",
    "padding_captions",
]


def entities_process(
    detected_entities: Sequence[str], mask_probability: float, rng: random.Random | None = None
) -> List[str]:
    if mask_probability == 0:
        return list(detected_entities)
    rng = rng or random
    return [e for e in detected_entities if rng.random() >= mask_probability]


def compose_discrete_prompts(tokenizer, entities: Sequence[str]) -> np.ndarray:
    head, tail = "There are", " in this audio."
    if len(entities) == 0:
        prompt = head + " something" + tail
    else:
        body = "".join(f" {e}," for e in entities)[:-1]
        prompt = head + body + tail
    return np.asarray(tokenizer.encode(prompt), np.int64)


def parse_entities(
    tokenizer, detected_entities: Sequence[str], mask_probability: float,
    rng: random.Random | None = None,
) -> np.ndarray:
    return compose_discrete_prompts(
        tokenizer, entities_process(detected_entities, mask_probability, rng)
    )


def padding_captions(
    hard_prompts: Sequence[np.ndarray],
    max_length: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad token id sequences to a common length; returns (tokens, mask).

    With ``max_length=None`` pads to the batch max; a fixed ``max_length``
    gives fixed shapes.
    """
    target = max_length or max(len(h) for h in hard_prompts)
    out = np.zeros((len(hard_prompts), target), np.int64)
    mask = np.zeros((len(hard_prompts), target), np.float32)
    for i, h in enumerate(hard_prompts):
        L = min(len(h), target)
        out[i, :L] = h[:L]
        mask[i, :L] = 1.0
    return out, mask
