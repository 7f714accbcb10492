"""MAGIC: CLAP-guided contrastive decoding.

The counterpart of the JAX package's ``decoding/magic.py`` (the reference's
``magic_search`` and ``generate_beam_magic``). Each step takes the top-k next
tokens of every row, probes each one step through GPT-2 and ranks them by

    (1 - alpha) * p(token) - alpha * max-cosine(candidate hidden, context hiddens)
        + beta * log-softmax over the row's candidates of CLAP(audio, candidate text)

(greedy). Beam MAGIC ranks by ``(1 - alpha) * log p(token)`` in the first
term and keeps length-normalized sums, with the reference's stopped-row
forcing. The context hiddens are every position's post-``ln_f`` state, the
prefix included.

Where each part runs:

- the probe and the commit on the device: the k candidates of a row attend
  over the row's cache without copying it (``models.gpt2.gpt2_probe_step``),
  and the chosen candidate's k/v is then written into it
  (``gpt2_commit_probe``; with ``quant=True`` the int8 cache and its q8
  forms);
- the candidates' text on the host: detokenized and WordPiece-tokenized in
  full, or incrementally (``IncrementalWordPiece``) where the scorer's text
  tower takes WordPiece ids and the LM tokenizer gives each token's bytes;
- the CLAP text tower on the device, its log-softmax over each row's
  candidates in fp32 there (``_clap_logprobs_device``) or in numpy
  (``clap_logprobs``) for an encoder that returns numpy;
- the score and the selection in fp32 numpy on the host, in the form of the
  JAX package's host loop (``np.argmax``: the first index wins; the beam
  selection verbatim, ``np.argsort`` included).

The top-k of the candidates is k ``argmax`` passes (``decoding.beam.
_topk_argmax``): equal values come out lower index first, as ``lax.top_k``
orders them. Not ported: the JAX package's fused device steps, the text
tower's deduplication and shape buckets, and the packed fetch, which answer a
remote TPU's round trips; their outputs equal the host loop's.
"""

from __future__ import annotations

import json
import types
import zipfile
from typing import Callable, List, Optional

import numpy as np
import torch

from zs_aac_tpu_torch.decoding.beam import _topk_argmax
from zs_aac_tpu_torch.models.gpt2 import (
    GPT2Config,
    expand_beam_cache,
    gpt2_commit_probe,
    gpt2_commit_probe_q8,
    gpt2_embed,
    gpt2_prefill,
    gpt2_probe_step,
    gpt2_probe_step_q8,
    init_kv_cache,
    quantize_kv_cache,
    reorder_beam_cache,
)
from zs_aac_tpu_torch.ops.quant import _const, div
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["magic_search", "magic_search_batched", "generate_beam_magic",
           "generate_beam_magic_batched", "make_magic_scorer", "clap_logprobs",
           "text_encoder", "wordpiece_ids", "IncrementalWordPiece"]


# ---------------------------------------------------------------------------
# Probe and commit
# ---------------------------------------------------------------------------


def _degeneration_penalty(context, hidden):
    """Max cosine of each candidate's hidden state [B, k, D] against the
    valid context hiddens [B, n, D] -> [B, k]."""
    ch = context / torch.clamp_min(torch.linalg.vector_norm(context, dim=-1, keepdim=True),
                                   1e-12)
    nh = hidden / torch.clamp_min(torch.linalg.vector_norm(hidden, dim=-1, keepdim=True),
                                  1e-12)
    return (nh @ ch.transpose(-1, -2)).amax(dim=-1)


def _probe_step(params, cfg: GPT2Config, logits, cache, width: int, index: int, context,
                context_len: int, alpha: float, quant: bool = False, log: bool = False):
    """Expand each row's ``width`` best next tokens of ``logits`` [B, V]
    (probabilities, or log-probabilities for beam MAGIC) one step over the
    row's cache at ``index``. Returns (candidate ids [B, k], the non-CLAP
    score ``(1 - alpha) * p - alpha * deg`` [B, k] fp32, probe logits
    [B, k, V], the candidates' k/v, their hidden states [B, k, D])."""
    p = torch.log_softmax(logits, dim=-1) if log else torch.softmax(logits, dim=-1)
    top_p, top_ids = _topk_argmax(p, width)
    probe = gpt2_probe_step_q8 if quant else gpt2_probe_step
    plogits, new_kv, hidden = probe(params, cfg, gpt2_embed(params, top_ids), cache, index)
    deg = _degeneration_penalty(context[:, :context_len], hidden)
    a = _const(float(alpha), top_p.device)
    base = (1 - a) * top_p - a * deg
    return top_ids, base.float(), plogits, new_kv, hidden


def _commit(cache, new_kv, sel, plogits, hidden, context, commit_index: int,
            context_len: int, quant: bool = False):
    """Write each row's selected candidate (``sel`` [B]) into the cache at
    ``commit_index`` and its hidden state into the context, in place.
    Returns the selected candidates' logits [B, V]."""
    (gpt2_commit_probe_q8 if quant else gpt2_commit_probe)(cache, new_kv, sel, commit_index)
    rows = torch.arange(sel.shape[0], device=sel.device)
    context[:, context_len] = hidden[rows, sel]
    return plogits[rows, sel]


def _commit_beam(cache, new_kv, src, wsel, plogits, hidden, context, commit_index: int,
                 context_len: int):
    """Beam form of ``_commit``: each row ``b * K + j`` takes source beam
    ``src[b, j]``'s history (``reorder_beam_cache``) and its candidate
    ``wsel[b * K + j]``. Returns (the selected logits [B * K, V], the
    reordered context)."""
    B, K = src.shape
    srcg = (torch.arange(B, device=src.device)[:, None] * K + src).reshape(-1)
    reorder_beam_cache(cache, src, commit_index)
    k_new, v_new = new_kv
    gpt2_commit_probe(cache, (k_new[:, srcg], v_new[:, srcg]), wsel, commit_index)
    context = context[srcg]
    context[:, context_len] = hidden[srcg, wsel]
    return plogits[srcg, wsel], context


def _fetch(ids, base):
    """The step's candidate ids [B, k] int64 and scores [B, k] fp32 on the
    host, in one copy."""
    packed = torch.stack([ids.float(), base]).cpu().numpy()
    return packed[0].astype(np.int64), packed[1]


def _prefill(params, cfg, prefix_embeds, T, quant=False):
    """Prefill at B rows: (last logits [B, V] fp32, cache, hidden [B, Lp, D])."""
    B = prefix_embeds.shape[0]
    cache = init_kv_cache(cfg, B, T, prefix_embeds.dtype, prefix_embeds.device)
    logits_seq, cache, hidden = gpt2_prefill(params, cfg, prefix_embeds, cache,
                                             return_hidden=True)
    if quant:   # the float prefill's cache quantized, its zero rows included
        cache = quantize_kv_cache(cache)
    return logits_seq[:, -1].float(), cache, hidden


# ---------------------------------------------------------------------------
# The CLAP term
# ---------------------------------------------------------------------------


def clap_logprobs(audio_embed: np.ndarray, text_embeds: np.ndarray, temp: float) -> np.ndarray:
    """Log-softmax over the candidates of the audio-text similarities / temp
    (the reference's ``compute_audio_text_similarity_via_embeddings``)."""
    a = audio_embed / max(np.linalg.norm(audio_embed), 1e-12)
    t = text_embeds / np.maximum(np.linalg.norm(text_embeds, axis=-1, keepdims=True), 1e-12)
    logits = (t @ a) / temp
    logits = logits - logits.max()
    return logits - np.log(np.exp(logits).sum())


def _clap_logprobs_device(audio, text, temp: float) -> np.ndarray:
    """[B, E] x [B, k, E] tensors -> [B, k] per-row log-softmax over the
    candidates on the host: the device twin of ``clap_logprobs``, in fp32
    whatever the tower's dtype (the JAX twin multiplies in the tower's dtype,
    which for a bf16 tower rounds the similarities / temp to 1/16 near 14)."""
    a, t = audio.float(), text.float()
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
    t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-12)
    logits = div((t @ a[:, :, None])[..., 0], temp)
    return torch.log_softmax(logits, dim=-1).cpu().numpy()


def make_magic_scorer(clap_ckpt: Optional[str], tokenizer,
                      encode_text_fn: Optional[Callable[[List[str]], object]] = None,
                      temp: float = 0.07, q8_tower: bool = False, device="cuda"):
    """fn(audio_embed [E], candidate token lists) -> [k] CLAP log-softmax
    scores, with ``.batched(audio_embeds [B, E], B lists of k candidate
    lists) -> [B, k]``.

    ``encode_text_fn`` maps strings to CLAP text embeddings (numpy, or a
    tensor); without it the ASE text tower is loaded from ``clap_ckpt`` onto
    ``device`` (``_load_ase_text_encoder``; ``q8_tower``: the w8a8 tower).
    An encoder whose ``.device`` namespace takes WordPiece ids gives the
    scorer a ``.device`` namespace too, which the decode loops read to build
    the ids incrementally."""
    if encode_text_fn is None:
        if clap_ckpt is None:
            raise ValueError("MAGIC needs --clap_ckpt or an injected text encoder")
        encode_text_fn = _load_ase_text_encoder(clap_ckpt, q8_tower=q8_tower, device=device)

    def as_numpy(embs):
        return embs.float().cpu().numpy() if isinstance(embs, torch.Tensor) else np.asarray(embs)

    def scorer(audio_embed, candidate_ids) -> np.ndarray:
        texts = [tokenizer.decode(ids) for ids in candidate_ids]
        embs = as_numpy(encode_text_fn(texts))
        return clap_logprobs(np.asarray(audio_embed).reshape(-1), embs, temp)

    def scorer_batched(audio_embeds, candidate_ids) -> np.ndarray:
        B, k = len(candidate_ids), len(candidate_ids[0])
        texts = [tokenizer.decode(ids) for row in candidate_ids for ids in row]
        embs = encode_text_fn(texts)
        if isinstance(embs, torch.Tensor):
            audio = torch.as_tensor(np.asarray(audio_embeds, np.float32), device=embs.device)
            return _clap_logprobs_device(audio.reshape(B, -1), embs.reshape(B, k, -1), temp)
        embs = np.asarray(embs).reshape(B, k, -1)
        out = np.empty((B, k), np.float32)
        for b in range(B):
            out[b] = clap_logprobs(np.asarray(audio_embeds[b]).reshape(-1), embs[b], temp)
        return out

    scorer.batched = scorer_batched
    dev = getattr(encode_text_fn, "device", None)
    if dev is not None:
        scorer.device = types.SimpleNamespace(
            encode_ids=dev.encode_ids, temp=temp, tokenizer=tokenizer,
            wordpiece=getattr(dev, "wordpiece", None))
    return scorer


class _ClapTerm:
    """The CLAP term of a decode loop over ``rows`` rows: through the
    scorer's ``.batched`` on candidate token lists, or, where the scorer's
    tower takes WordPiece ids and the LM tokenizer gives each token's bytes,
    through ``IncrementalWordPiece`` (the same id matrices, tokenized one
    word at a time)."""

    def __init__(self, score_fn, audio_rows: np.ndarray):
        self.score_fn = score_fn
        self.audio = audio_rows
        dev = getattr(score_fn, "device", None)
        self.dev = dev
        self.incr = None
        if (dev is not None and dev.wordpiece is not None
                and hasattr(dev.tokenizer, "token_bytes")):
            self.incr = IncrementalWordPiece(dev.wordpiece, dev.tokenizer, len(audio_rows))

    def __call__(self, top_ids: np.ndarray, prev) -> np.ndarray:
        """[rows, k] log-softmax scores of ``top_ids`` [rows, k] appended to
        each row's tokens so far (``prev(r)``, a list)."""
        rows, k = top_ids.shape
        if self.incr is not None:
            ids = self.incr.matrix([r for g in range(rows)
                                    for r in self.incr.candidate_rows(g, top_ids[g])])
            embs = self.dev.encode_ids(ids)
            audio = torch.as_tensor(self.audio, device=embs.device)
            return _clap_logprobs_device(audio, embs.reshape(rows, k, -1), self.dev.temp)
        cand = [[prev(g) + [int(t)] for t in top_ids[g]] for g in range(rows)]
        batched = getattr(self.score_fn, "batched", None)
        if batched is not None:
            return np.asarray(batched(self.audio, cand))
        return np.stack([self.score_fn(self.audio[g], cand[g]) for g in range(rows)])

    def commit(self, row: int, token: int) -> None:
        if self.incr is not None:
            self.incr.commit(row, token)

    def reorder(self, srcg) -> None:
        if self.incr is not None:
            self.incr.reorder(srcg)


# ---------------------------------------------------------------------------
# The CLAP text tower
# ---------------------------------------------------------------------------


def wordpiece_ids(wordpiece, texts) -> np.ndarray:
    """The text tower's upload of ``texts``: [CLS] ... [SEP] WordPiece ids,
    int16, padded with 0 to the smallest of 8, 16 and 30 that holds the
    longest (the JAX loader's; the masked tower does not see the padding)."""
    ids, mask = wordpiece.batch_encode(texts, max_length=30, pad_to_max=True)
    ids = np.asarray(ids, np.int16)
    actual = int(np.asarray(mask).sum(1).max())
    for bucket in (8, 16, 30):
        if actual <= bucket:
            return ids[:, :bucket]
    return ids


def text_encoder(variables: dict, text_model: str, wordpiece, q8_tower: bool = False,
                 dtype=torch.float32):
    """The CLAP text tower of ASE ``variables`` (tensors on their device) as
    a string encoder: ``encode(texts) -> [n, E]`` L2-normalized embeddings
    on the device (through ``wordpiece_ids``), with
    ``encode.device.encode_ids(ids)`` for id matrices (0 = pad).
    The float tower is the ASE's (BERT, CLIP or GPT-2, as the JAX float path
    serves them); ``q8_tower`` serves the BERT tower with w8a8 GEMMs
    (``models/bert_q8.py``) and is refused for CLIP and GPT-2 towers."""
    from zs_aac_tpu_torch.models.ase import (CLIP_TEXT_REGISTRY, GPT2_TEXT_REGISTRY, _l2norm,
                                             _proj, build_text_tower, text_config)

    if q8_tower and (text_model in CLIP_TEXT_REGISTRY or text_model in GPT2_TEXT_REGISTRY):
        raise ValueError("--q8_tower supports BERT-family text towers only; "
                         f"checkpoint uses {text_model!r}")
    p = variables["params"]
    device = p["text_proj"]["fc1"]["kernel"].device
    if q8_tower:
        from zs_aac_tpu_torch.models.bert_q8 import encode_text_q8, quantize_text_tower_int8

        bcfg = text_config(text_model)
        qt = quantize_text_tower_int8(variables, bcfg)

        def tower(ids):
            return encode_text_q8(qt, bcfg, ids)
    else:
        # the ASE's encode_text: BERT, CLIP or GPT-2 (WordPiece [PAD] is 0)
        text_enc = build_text_tower(text_model, dtype)

        def tower(ids):
            hidden = text_enc.apply(p["text_enc"], ids, (ids != 0).int())
            return _l2norm(_proj(hidden[:, 0, :], p["text_proj"], dtype))

    @torch.no_grad()
    def encode_ids(ids):
        return tower(torch.from_numpy(np.asarray(ids, np.int64)).to(device))

    def encode(texts):
        return encode_ids(wordpiece_ids(wordpiece, texts))

    encode.device = types.SimpleNamespace(encode_ids=encode_ids, wordpiece=wordpiece)
    return encode


def _load_ase_text_encoder(path: str, q8_tower: bool = False, device="cuda"):
    """The CLAP text tower of an ASE checkpoint, as ``text_encoder`` gives
    it, on ``device``. ``path`` is the JAX package's msgpack parameter
    snapshot, or a file of the port's own: a train state of its training
    drivers, or a reference-layout checkpoint (``load_ase_variables``);
    ``path + ".json"`` holds ``{"ase_config", "bert_tokenizer"}`` (the
    config's fields and the WordPiece vocabulary's path)."""
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu_torch.models.ase import ASEConfig
    from zs_aac_tpu_torch.models.convert import from_jax_params
    from zs_aac_tpu_torch.utils.checkpoints import load_ase_variables, load_params

    dev = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)

    def detuple(v):   # json has no tuples; the config's tuple fields come back
        return tuple(detuple(e) for e in v) if isinstance(v, list) else v

    cfg = ASEConfig(**{k: detuple(v) for k, v in meta["ase_config"].items()
                       if k in ASEConfig.__dataclass_fields__})
    if zipfile.is_zipfile(path):          # torch.save: the port's own files
        variables = load_ase_variables(path, cfg, device=dev)
    else:
        variables = from_jax_params(load_params(path), device=dev)
    if meta.get("bert_tokenizer") is None:
        raise ValueError("ASE checkpoint sidecar must name its bert_tokenizer")
    wordpiece = WordPieceTokenizer.from_file(meta["bert_tokenizer"])
    return text_encoder(variables, cfg.text_model, wordpiece, q8_tower=q8_tower)


class IncrementalWordPiece:
    """LM tokens -> WordPiece ids, one word at a time (a copy of the JAX
    package's class, less its deduplicating ``candidate_matrix``).

    Re-encoding each candidate's whole text through WordPiece every step
    redoes the unchanged prefix. Per row this keeps ``stable``, the
    WordPiece ids of every word before the committed text's last ASCII
    whitespace byte, and ``tail``, the bytes after it. Appending a token's
    bytes changes the basic tokenization only from that whitespace on (BERT
    splits at whitespace, and bytes < 0x80 never occur inside a multi-byte
    UTF-8 sequence), so a candidate costs one word's tokenization, and none
    once ``stable`` fills the ``max_length - 2`` pieces the tower keeps. The
    id matrices equal full re-tokenization's (``tests/test_torch_magic.py``)."""

    _WS = (b" ", b"\t", b"\n", b"\r")

    def __init__(self, wp, lm_tokenizer, batch: int, max_length: int = 30):
        self.wp = wp
        self.lm = lm_tokenizer
        self.body = max_length - 2                      # room next to CLS/SEP
        self.max_length = max_length
        self.stable: List[List[int]] = [[] for _ in range(batch)]
        self.tail: List[bytes] = [b"" for _ in range(batch)]
        self._unk = wp.stoi[wp.unk]
        self._cls = wp.stoi[wp.cls]
        self._sep = wp.stoi[wp.sep]
        self._pad = wp.stoi.get(wp.pad, 0)
        self._tok_bytes: dict = {}
        self._piece_cache: dict = {}

    def _bytes(self, tid: int) -> bytes:
        b = self._tok_bytes.get(tid)
        if b is None:
            b = self._tok_bytes[tid] = self.lm.token_bytes(tid)
        return b

    def _pieces(self, data: bytes) -> List[int]:
        ids = self._piece_cache.get(data)
        if ids is None:
            stoi = self.wp.stoi
            ids = [stoi.get(t, self._unk)
                   for t in self.wp.tokenize(data.decode("utf-8", "replace"))]
            self._piece_cache[data] = ids
        return ids

    def candidate_rows(self, b: int, cand_token_ids) -> List[List[int]]:
        """WordPiece ids (no specials, untruncated) for each candidate LM
        token appended to row ``b``'s committed text."""
        st = self.stable[b]
        if len(st) >= self.body:        # truncation makes the tail invisible
            return [st for _ in cand_token_ids]
        tl = self.tail[b]
        return [st + self._pieces(tl + self._bytes(int(t))) for t in cand_token_ids]

    def commit(self, b: int, token_id: int) -> None:
        """Append the selected LM token to row ``b``'s committed text."""
        if len(self.stable[b]) >= self.body:
            return
        data = self.tail[b] + self._bytes(int(token_id))
        cut = max(data.rfind(w) for w in self._WS)
        if cut >= 0:
            self.stable[b] = self.stable[b] + self._pieces(data[:cut])
            self.tail[b] = data[cut + 1:]
        else:
            self.tail[b] = data

    def reorder(self, src) -> None:
        """Rows take the state of rows ``src`` (beam ancestry, global row
        indices). ``commit`` rebinds the per-row entries, so aliasing is
        safe."""
        self.stable = [self.stable[int(s)] for s in src]
        self.tail = [self.tail[int(s)] for s in src]

    def matrix(self, rows: List[List[int]]) -> np.ndarray:
        """CLS/SEP-wrapped, truncated rows padded to the smallest of 8, 16 and
        ``max_length`` that holds the longest: ``wordpiece_ids``' layout
        (int16, PAD id fill)."""
        wrapped = [[self._cls] + r[: self.body] + [self._sep] for r in rows]
        longest = max(len(r) for r in wrapped)
        bucket = next((bk for bk in (8, 16, self.max_length) if longest <= bk), longest)
        ids = np.full((len(wrapped), bucket), self._pad, np.int16)
        for i, r in enumerate(wrapped):
            ids[i, : len(r)] = r
        return ids


# ---------------------------------------------------------------------------
# Greedy MAGIC
# ---------------------------------------------------------------------------


@torch.no_grad()
def magic_search_batched(gpt2_params: dict, cfg: GPT2Config, prefix_embeds,
                         audio_embeds, score_fn, beam_width: int = 25, alpha: float = 0.1,
                         beta: float = 0.2, decoding_len: int = 67, stop_token_id: int = 13,
                         quant: bool = False) -> List[List[int]]:
    """Greedy MAGIC over a clip batch: ``prefix_embeds`` [B, Lp, D] (on the
    decode's device), ``audio_embeds`` [B, E] CLAP audio embeddings. Returns
    B token-id lists, each clip's the same as its decode alone. A finished
    clip keeps committing its argmax; its recorded tokens stop. ``quant``
    keeps the history in the int8 KV cache (``gpt2_probe_step_q8``)."""
    B, Lp, D = prefix_embeds.shape
    T = Lp + decoding_len
    audio_embeds = np.asarray(audio_embeds, np.float32).reshape(B, -1)
    logits, cache, hidden = _prefill(gpt2_params, cfg, prefix_embeds, T, quant)
    context = torch.zeros(B, T, D, dtype=prefix_embeds.dtype, device=prefix_embeds.device)
    context[:, :Lp] = hidden
    context_len = Lp
    clap = _ClapTerm(score_fn, audio_embeds)

    generated: List[List[int]] = [[] for _ in range(B)]
    finished = np.zeros(B, bool)
    ids, base, plogits, new_kv, hidden = _probe_step(
        gpt2_params, cfg, logits, cache, beam_width, Lp, context, context_len, alpha, quant)
    for step in range(decoding_len):
        top_ids, base_np = _fetch(ids, base)
        scores = base_np + beta * clap(top_ids, lambda b: generated[b])
        sel = np.argmax(scores, axis=-1)
        for b in range(B):
            if not finished[b]:
                tok = int(top_ids[b, sel[b]])
                generated[b].append(tok)
                clap.commit(b, tok)
                if tok == stop_token_id:
                    finished[b] = True
        if finished.all() or step == decoding_len - 1:
            break
        sel_t = torch.from_numpy(sel).to(prefix_embeds.device)
        logits = _commit(cache, new_kv, sel_t, plogits, hidden, context, Lp + step,
                         context_len, quant)
        context_len += 1
        ids, base, plogits, new_kv, hidden = _probe_step(
            gpt2_params, cfg, logits, cache, beam_width, Lp + step + 1, context, context_len,
            alpha, quant)
    return generated


def magic_search(gpt2_params: dict, cfg: GPT2Config, prefix_embeds, audio_embed, score_fn,
                 beam_width: int = 25, alpha: float = 0.1, beta: float = 0.2,
                 decoding_len: int = 67, stop_token_id: int = 13,
                 quant: bool = False) -> List[int]:
    """Single-clip MAGIC (``prefix_embeds`` [1, Lp, D]): ``magic_search_batched``
    at B=1."""
    return magic_search_batched(
        gpt2_params, cfg, prefix_embeds, np.asarray(audio_embed).reshape(1, -1), score_fn,
        beam_width, alpha, beta, decoding_len, stop_token_id, quant)[0]


# ---------------------------------------------------------------------------
# Beam MAGIC
# ---------------------------------------------------------------------------


def _beam_start(gpt2_params, cfg, prefix_embeds, beam_size, T):
    """Prefill at B rows, then one cache row, context and logits row per
    beam (row ``b * beam_size + j``)."""
    B, Lp, D = prefix_embeds.shape
    logits, cache, hidden = _prefill(gpt2_params, cfg, prefix_embeds, T)
    cache = expand_beam_cache(cache, beam_size)
    context = torch.zeros(B * beam_size, T, D, dtype=prefix_embeds.dtype,
                          device=prefix_embeds.device)
    context[:, :Lp] = hidden.repeat_interleave(beam_size, dim=0)
    return logits.repeat_interleave(beam_size, dim=0), cache, context


@torch.no_grad()
def generate_beam_magic(gpt2_params: dict, cfg: GPT2Config, prefix_embeds, audio_embed,
                        score_fn, beam_size: int = 3, magic_width: int = 25,
                        alpha: float = 0.1, beta: float = 0.2, entry_length: int = 67,
                        stop_token_id: int = 13):
    """Beam search of one clip (``prefix_embeds`` [1, Lp, D]) ranked by the
    MAGIC score with the log-probability LM term, stopped-row forcing and
    length-normalized selection (the reference's ``generate_beam_magic``).
    Returns (token lists, scores), best first."""
    _, Lp, D = prefix_embeds.shape
    dev = prefix_embeds.device
    logits, cache, context = _beam_start(gpt2_params, cfg, prefix_embeds, beam_size,
                                         Lp + entry_length)
    context_len = Lp
    tokens = np.zeros((beam_size, entry_length), np.int64)
    scores = None
    seq_lengths = np.ones(beam_size)
    is_stopped = np.zeros(beam_size, bool)
    ids, base, plogits, new_kv, hidden = _probe_step(
        gpt2_params, cfg, logits, cache, magic_width, Lp, context, context_len, alpha, log=True)
    for i in range(entry_length):
        ids_np, base_np = _fetch(ids, base)
        clap = np.zeros((beam_size, magic_width), np.float32)
        for b in range(beam_size):
            prev = list(tokens[b][:i]) if i else []
            clap[b] = score_fn(audio_embed, [prev + [int(t)] for t in ids_np[b]])
        magic = base_np + beta * clap
        if scores is None:
            order = np.argsort(-magic[0])[:beam_size]
            scores = magic[0][order]
            nxt = ids_np[0][order]
            src = np.zeros(beam_size, np.int64)     # every beam from beam 0's row
            wsel = order
        else:
            m = magic.copy()
            m[is_stopped] = -np.inf
            m[is_stopped, 0] = 0.0
            scores_sum = scores[:, None] + m
            seq_lengths[~is_stopped] += 1
            avg = scores_sum / seq_lengths[:, None]
            flat = np.argsort(-avg.reshape(-1))[:beam_size]
            src = flat // magic_width
            wsel = flat % magic_width
            seq_lengths = seq_lengths[src]
            nxt = ids_np[src, wsel]
            tokens = tokens[src]
            is_stopped = is_stopped[src]
            scores = avg.reshape(-1)[flat] * seq_lengths
        tokens[:, i] = nxt
        is_stopped = is_stopped | (nxt == stop_token_id)
        if is_stopped.all() or i == entry_length - 1:
            break
        logits, context = _commit_beam(
            cache, new_kv, torch.from_numpy(src[None]).to(dev),
            torch.from_numpy(np.asarray(wsel)).to(dev), plogits, hidden, context, Lp + i,
            context_len)
        context_len += 1
        ids, base, plogits, new_kv, hidden = _probe_step(
            gpt2_params, cfg, logits, cache, magic_width, Lp + i + 1, context, context_len,
            alpha, log=True)

    final = scores / seq_lengths
    order = np.argsort(-final)
    return [list(tokens[b][: int(seq_lengths[b])]) for b in order], final[order]


@torch.no_grad()
def generate_beam_magic_batched(gpt2_params: dict, cfg: GPT2Config, prefix_embeds,
                                audio_embeds, score_fn, beam_size: int = 3,
                                magic_width: int = 25, alpha: float = 0.1, beta: float = 0.2,
                                entry_length: int = 67, stop_token_id: int = 13):
    """Beam MAGIC over a clip batch, each clip's beams ``generate_beam_magic``'s:
    the probe, the commit and the text tower take B x beam_size rows at once,
    the selection runs per clip in numpy (the JAX host loop's block, dtype
    promotions included). Returns (token lists [B][beam_size] best first per
    clip, scores [B, beam_size] fp32)."""
    B, Lp, D = prefix_embeds.shape
    BM, w = B * beam_size, magic_width
    dev = prefix_embeds.device
    audio_embeds = np.asarray(audio_embeds, np.float32).reshape(B, -1)
    logits, cache, context = _beam_start(gpt2_params, cfg, prefix_embeds, beam_size,
                                         Lp + entry_length)
    context_len = Lp
    clap_term = _ClapTerm(score_fn, np.repeat(audio_embeds, beam_size, axis=0))

    tokens = np.zeros((B, beam_size, entry_length), np.int64)
    emitted = 0
    stopped = np.zeros((B, beam_size), bool)
    seq_host = np.ones((B, beam_size), np.float64)
    scores = None
    ids, base, plogits, new_kv, hidden = _probe_step(
        gpt2_params, cfg, logits, cache, w, Lp, context, context_len, alpha, log=True)
    for i in range(entry_length):
        ids_np, base_np = _fetch(ids, base)
        flat_tokens = tokens.reshape(BM, entry_length)
        clap = clap_term(ids_np, lambda g: list(flat_tokens[g, :emitted]))
        magic = base_np.reshape(B, beam_size, w) + beta * clap.reshape(B, beam_size, w)
        ids_np = ids_np.reshape(B, beam_size, w)

        # per clip, verbatim the single-clip block
        src = np.zeros((B, beam_size), np.int64)
        wsel = np.zeros((B, beam_size), np.int64)
        nxt = np.zeros((B, beam_size), np.int64)
        if scores is None:
            # per-clip arrays, so numpy's dtype promotion follows the
            # single-clip loop (float32 first, float64 from the first
            # length-normalized update on)
            scores = [None] * B
            for b in range(B):
                order = np.argsort(-magic[b, 0])[:beam_size]
                scores[b] = magic[b, 0][order]
                nxt[b] = ids_np[b, 0][order]
                wsel[b] = order
        else:
            for b in range(B):
                m = magic[b].copy()
                m[stopped[b]] = -np.inf
                m[stopped[b], 0] = 0.0
                scores_sum = scores[b][:, None] + m
                seq_host[b][~stopped[b]] += 1
                avg = scores_sum / seq_host[b][:, None]
                flat = np.argsort(-avg.reshape(-1))[:beam_size]
                src[b] = flat // w
                wsel[b] = flat % w
                seq_host[b] = seq_host[b][src[b]]
                nxt[b] = ids_np[b, src[b], wsel[b]]
                tokens[b] = tokens[b][src[b]]
                stopped[b] = stopped[b][src[b]]
                scores[b] = avg.reshape(-1)[flat] * seq_host[b]
        tokens[:, :, emitted] = nxt
        emitted += 1
        stopped = stopped | (nxt == stop_token_id)
        srcg = (np.arange(B)[:, None] * beam_size + src).reshape(BM)
        clap_term.reorder(srcg)
        for r, t in enumerate(nxt.reshape(BM)):
            clap_term.commit(r, int(t))
        if stopped.all() or i == entry_length - 1:
            break
        logits, context = _commit_beam(
            cache, new_kv, torch.from_numpy(src).to(dev),
            torch.from_numpy(wsel.reshape(BM)).to(dev), plogits, hidden, context, Lp + i,
            context_len)
        context_len += 1
        ids, base, plogits, new_kv, hidden = _probe_step(
            gpt2_params, cfg, logits, cache, w, Lp + i + 1, context, context_len, alpha,
            log=True)
    final = np.stack([scores[b] / seq_host[b] for b in range(B)]).astype(np.float32)

    out_tokens, out_scores = [], np.zeros((B, beam_size), np.float32)
    for b in range(B):
        order = np.argsort(-final[b])
        out_tokens.append([list(tokens[b, j, : int(seq_host[b, j])]) for j in order])
        out_scores[b] = final[b][order]
    return out_tokens, out_scores
