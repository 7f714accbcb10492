"""WordPiece tokenizer for the BERT text tower (a copy of the JAX package's
``data/bert_tokenizer.py``).

The reference tokenizes captions with HF ``BertTokenizer`` inside its text
encoder (``padding='longest'`` truncated to 30, special tokens added). This
is a self-contained implementation over a standard ``vocab.txt``, so a
published BERT vocabulary drops in without network access.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["WordPieceTokenizer"]


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    def __init__(self, vocab: List[str], lowercase: bool = True,
                 unk: str = "[UNK]", cls: str = "[CLS]", sep: str = "[SEP]",
                 pad: str = "[PAD]", max_chars_per_word: int = 100):
        self.itos = list(vocab)
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.lowercase = lowercase
        self.unk, self.cls, self.sep, self.pad = unk, cls, sep, pad
        self.max_chars = max_chars_per_word

    @classmethod
    def from_file(cls, vocab_txt: str, **kw) -> "WordPieceTokenizer":
        with open(vocab_txt, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f if line.strip() or line == "\n"]
        return cls(vocab, **kw)

    # --- basic tokenization (whitespace + punctuation split, lowercase) ---
    def _basic(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.stoi:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for w in self._basic(text):
            out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str, max_length: int = 30) -> List[int]:
        toks = [self.cls] + self.tokenize(text)[: max_length - 2] + [self.sep]
        return [self.stoi.get(t, self.stoi[self.unk]) for t in toks]

    def batch_encode(
        self, texts: Sequence[str], max_length: int = 30, pad_to_max: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """padding='longest' semantics (or fixed max_length for static shapes)."""
        encoded = [self.encode(t, max_length) for t in texts]
        L = max_length if pad_to_max else max(len(e) for e in encoded)
        pad_id = self.stoi.get(self.pad, 0)
        ids = np.full((len(texts), L), pad_id, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask
