"""SentencePiece ``.model`` loader without the ``sentencepiece`` package.

The counterpart of the JAX package's ``data/sentencepiece.py`` (a host
module; the port keeps its own copy). The Mistral captioner's tokenizer is a
SentencePiece model; this module reads the ``.model`` protobuf directly and
implements both segmentation algorithms:

- **unigram**: Viterbi max-score segmentation over the piece vocabulary
  with the standard unknown penalty (min piece score - 10).
- **BPE**: iterative best-scored adjacent merge (sentencepiece stores BPE
  merge priority as the piece score), the algorithm of Llama/Mistral's
  ``tokenizer.model``.

Both support byte-fallback pieces (``<0x00>``..``<0xFF>``) and the
``add_dummy_prefix`` / whitespace-escape (``▁``) normalizer options. Only
the protobuf fields the tokenizer needs are decoded:

ModelProto: 1=pieces (SentencePiece: 1=piece, 2=score, 3=type),
2=TrainerSpec (3=model_type 1:unigram/2:bpe, 40=unk_id, 41=bos_id,
42=eos_id, 43=pad_id), 3=NormalizerSpec (3=add_dummy_prefix,
5=escape_whitespaces).

``write_model`` emits the same format, so tests and fixtures build real
model files offline.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

__all__ = ["SentencePieceTokenizer", "write_model"]

_WS = "▁"  # '▁'

# piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2


# ---------------------------------------------------------------------------
# protobuf wire format (read/write just what we need)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    x = shift = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a protobuf message."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v, i = buf[i : i + 8], i + 8
        elif wt == 2:  # length-delimited
            n, i = _read_varint(buf, i)
            v, i = buf[i : i + n], i + n
        elif wt == 5:  # 32-bit
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _emit_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _emit_field(field: int, wt: int, payload: bytes) -> bytes:
    return _emit_varint((field << 3) | wt) + payload


def write_model(
    path: str,
    pieces: List[Tuple[str, float, int]],
    model_type: int = UNIGRAM,
    add_dummy_prefix: bool = True,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
) -> None:
    """Write a minimal but spec-conformant ``.model`` file.

    ``pieces``: list of (piece, score, type) in id order.
    """
    body = bytearray()
    for piece, score, ptype in pieces:
        sp = (
            _emit_field(1, 2, _emit_varint(len(piece.encode())) + piece.encode())
            + _emit_field(2, 5, struct.pack("<f", score))
            + _emit_field(3, 0, _emit_varint(ptype))
        )
        body += _emit_field(1, 2, _emit_varint(len(sp)) + sp)
    trainer = (
        _emit_field(3, 0, _emit_varint(model_type))
        + _emit_field(40, 0, _emit_varint(unk_id))
        + _emit_field(41, 0, _emit_varint(bos_id))
        + _emit_field(42, 0, _emit_varint(eos_id))
    )
    body += _emit_field(2, 2, _emit_varint(len(trainer)) + trainer)
    norm = _emit_field(3, 0, _emit_varint(1 if add_dummy_prefix else 0))
    body += _emit_field(3, 2, _emit_varint(len(norm)) + norm)
    with open(path, "wb") as f:
        f.write(bytes(body))


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


class SentencePieceTokenizer:
    """Encode/decode with a parsed SentencePiece model."""

    def __init__(
        self,
        pieces: List[Tuple[str, float, int]],
        model_type: int,
        add_dummy_prefix: bool,
        unk_id: int,
        bos_id: int,
        eos_id: int,
    ):
        self.pieces = pieces
        self.model_type = model_type
        self.add_dummy_prefix = add_dummy_prefix
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.piece_to_id: Dict[str, int] = {}
        # pieces matchable against raw text: NORMAL/USER_DEFINED only —
        # real sentencepiece never matches control/byte/unknown pieces as
        # literal substrings ('<s>' in user text must NOT become bos)
        self.match_to_id: Dict[str, int] = {}
        self.byte_pieces: Dict[int, int] = {}
        for i, (p, _, t) in enumerate(pieces):
            self.piece_to_id.setdefault(p, i)
            if t in (NORMAL, USER_DEFINED):
                self.match_to_id.setdefault(p, i)
            if t == BYTE:
                self.byte_pieces[int(p[1:-1], 16)] = i
        self._scores = [s for _, s, _ in pieces]
        self._min_score = min(self._scores) if self._scores else 0.0
        self._max_piece_len = max((len(p) for p, _, _ in pieces), default=1)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            buf = f.read()
        pieces: List[Tuple[str, float, int]] = []
        model_type = UNIGRAM
        add_dummy_prefix = True
        unk_id, bos_id, eos_id = 0, 1, 2
        for field, wt, v in _fields(buf):
            if field == 1 and wt == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _fields(v):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wt == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(v):
                    if f2 == 3:
                        model_type = v2
                    elif f2 == 40:
                        unk_id = v2
                    elif f2 == 41:
                        bos_id = v2
                    elif f2 == 42:
                        eos_id = v2
            elif field == 3 and wt == 2:  # NormalizerSpec
                for f2, w2, v2 in _fields(v):
                    if f2 == 3:
                        add_dummy_prefix = bool(v2)
        return cls(pieces, model_type, add_dummy_prefix, unk_id, bos_id, eos_id)

    # -- properties ---------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        text = text.replace(" ", _WS)
        if self.add_dummy_prefix and not text.startswith(_WS):
            text = _WS + text
        return text

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        s = self._normalize(text)
        if self.model_type == BPE:
            ids = self._encode_bpe(s)
        else:
            ids = self._encode_unigram(s)
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def _fallback(self, segment: str) -> List[int]:
        """Unknown segment -> byte pieces when available, else unk_id."""
        if self.byte_pieces:
            out = []
            for b in segment.encode("utf-8"):
                out.append(self.byte_pieces.get(b, self.unk_id))
            return out
        return [self.unk_id]

    def _encode_unigram(self, s: str) -> List[int]:
        """Viterbi best segmentation by summed piece scores; unknown single
        chars get ``min_score - 10`` (sentencepiece's unk penalty)."""
        n = len(s)
        unk_score = self._min_score - 10.0
        best = [-math.inf] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -math.inf:
                continue
            for L in range(1, min(self._max_piece_len, n - i) + 1):
                pid = self.match_to_id.get(s[i : i + L])
                if pid is not None:
                    sc = best[i] + self._scores[pid]
                    if sc > best[i + L]:
                        best[i + L] = sc
                        back[i + L] = (i, pid)
            # unknown single char
            sc = best[i] + unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, -1)
        ids: List[int] = []
        i = n
        while i > 0:
            start, pid = back[i]
            if pid == -1:
                ids = self._fallback(s[start:i]) + ids
            else:
                ids = [pid] + ids
            i = start
        return ids

    def _encode_bpe(self, s: str) -> List[int]:
        """Iterative highest-score adjacent merge (sentencepiece BPE)."""
        symbols = list(s)
        while len(symbols) > 1:
            best_score, best_i = -math.inf, -1
            for i in range(len(symbols) - 1):
                pid = self.match_to_id.get(symbols[i] + symbols[i + 1])
                if pid is not None and self._scores[pid] > best_score:
                    best_score, best_i = self._scores[pid], i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids: List[int] = []
        for sym in symbols:
            pid = self.match_to_id.get(sym)
            if pid is None:
                ids += self._fallback(sym)
            else:
                ids.append(pid)
        return ids

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: List[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            piece, _, ptype = self.pieces[i]
            if ptype == BYTE:
                byte_buf.append(int(piece[1:-1], 16))
                continue
            flush()
            if ptype in (CONTROL, UNKNOWN):
                continue
            out.append(piece)
        flush()
        text = "".join(out).replace(_WS, " ")
        # only the dummy prefix is stripped; without it a leading space is
        # genuine input
        if self.add_dummy_prefix and text.startswith(" "):
            return text[1:]
        return text
