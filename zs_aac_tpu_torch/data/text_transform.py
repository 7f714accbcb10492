"""Caption text normalization (a copy of the JAX package's
``data/text_transform.py``, itself the reference retrieval code's
``data_handling/text_transform.py``)."""

from __future__ import annotations

from re import sub

__all__ = ["text_preprocess"]


def text_preprocess(sentence: str) -> str:
    sentence = sentence.lower()
    # remove any forgotten space before punctuation and double space
    sentence = sub(r'\s([,.!?;:"](?:\s|$))', r"\1", sentence).replace("  ", " ")
    # remove punctuation
    sentence = sub('[(,.!?;:|*")]', " ", sentence).replace("  ", " ")
    return sentence
