"""The port's MAGIC decoding (``decoding/magic.py``), its GPT-2 probe and
commit steps and the int8 text tower (``models/bert_q8.py``) against the JAX
package's, on the same weights (moved by ``from_jax_params``) and the same
numpy-seeded inputs.

Tolerances: fp32 probe logits, hidden states and k/v 2e-5 (summation order
only, |x| <= ~10); int8 cache bytes equal, their scales rtol 1e-6; beam
scores rtol 1e-5; the bf16 int8 tower's embeddings 2e-2 of the JAX ones
(L2-normalized, entries ~0.2: one bf16 rounding of the activations moves an
int8 activation by one step). Token lists are identical.

The committed CLAP checkpoint (``testdata/tiny_clap/``: ``ase.msgpack``,
its ``.json`` sidecar, ``vocab.txt`` and ``audio_expected.json``, the JAX
audio embeddings of ``testdata.clap_waves()``) is written with
``PYTHONPATH=. python tests/test_torch_magic.py --write-fixture``, which also
records the MAGIC captions of the committed tiny captioner in its
``expected.json``.
"""

import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_magic_and_drivers import GCFG, STOP, _char_wordpiece, _train_bpe
from test_torch_bert_ase import register_tiny_bert_in_jax
from zs_aac_tpu.data.tokenizer import WordTokenizer as JaxWordTokenizer
from zs_aac_tpu.decoding import magic as jmagic
from zs_aac_tpu.models import gpt2 as jgpt2
from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
from zs_aac_tpu_torch.data.tokenizer import GPT2BPETokenizer, WordTokenizer
from zs_aac_tpu_torch.decoding import magic
from zs_aac_tpu_torch.models import gpt2
from zs_aac_tpu_torch.models.convert import from_jax_params
from zs_aac_tpu_torch.testdata import (FIXTURE_DIR, TINY_ASE_DIR, TINY_CLAP_DIR,
                                       stage_tiny_captioner)

torch.set_num_threads(2)

TOL = 2e-5
Q8_TOWER_TOL = 2e-2
WORDS = ["w%d" % i for i in range(48)]


def _params(seed, cfg=GCFG):
    jp = jgpt2.init_gpt2(jax.random.key(seed), cfg)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _crc_encode(texts, dim=16):
    """A fake CLAP text tower: a seeded random vector per distinct string."""
    return np.stack([np.random.default_rng(zlib.crc32(t.encode()) % (2**31))
                     .standard_normal(dim).astype(np.float32) for t in texts])


def _scorers(encode=_crc_encode):
    return (jmagic.make_magic_scorer(None, JaxWordTokenizer(WORDS), encode_text_fn=encode),
            magic.make_magic_scorer(None, WordTokenizer(WORDS), encode_text_fn=encode))


# --- GPT-2 probe and commit -------------------------------------------------


def _prefilled(seed, B=2, Lp=4, T=12):
    jp, tp = _params(seed)
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((B, Lp, GCFG.n_embd)).astype(np.float32)
    _, jcache = jgpt2.gpt2_prefill(jp, GCFG, jnp.asarray(prefix),
                                   jgpt2.init_kv_cache(GCFG, B, T))
    tcache = gpt2.init_kv_cache(GCFG, B, T, device="cpu")
    gpt2.gpt2_prefill(tp, GCFG, _t(prefix), tcache)
    return jp, tp, jcache, tcache, rng


def _assert_caches(tcache, jcache, names):
    for name in names:
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        if got.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=TOL, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "q8"])
def test_probe_and_commit_match_jax(quant):
    """Two probes and a commit between them, at W=5 candidates a row."""
    jp, tp, jcache, tcache, rng = _prefilled(1)
    if quant:
        jcache, tcache = jgpt2.quantize_kv_cache(jcache), gpt2.quantize_kv_cache(tcache)
    jprobe = jgpt2.gpt2_probe_step_q8 if quant else jgpt2.gpt2_probe_step
    jcommit = jgpt2.gpt2_commit_probe_q8 if quant else jgpt2.gpt2_commit_probe
    tprobe = gpt2.gpt2_probe_step_q8 if quant else gpt2.gpt2_probe_step
    tcommit = gpt2.gpt2_commit_probe_q8 if quant else gpt2.gpt2_commit_probe
    for index in (4, 5):
        ids = rng.integers(0, GCFG.vocab_size, (2, 5))
        emb = np.asarray(jgpt2.gpt2_embed(jp, jnp.asarray(ids)))
        jl, jkv, jh = jprobe(jp, GCFG, jnp.asarray(emb), jcache, index)
        tl, tkv, th = tprobe(tp, GCFG, _t(emb), tcache, index)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)
        for a, b in zip(tkv, jkv):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
        sel = rng.integers(0, 5, 2)
        jcache = jcommit(jcache, jkv, jnp.asarray(sel), index)
        tcommit(tcache, tkv, torch.from_numpy(sel), index)
        _assert_caches(tcache, jcache, jcache.keys())


def test_prefill_and_step_return_hidden_as_jax():
    jp, tp, jcache, tcache, rng = _prefilled(2)
    prefix = rng.standard_normal((2, 4, GCFG.n_embd)).astype(np.float32)
    jl, _, jh = jgpt2.gpt2_prefill(jp, GCFG, jnp.asarray(prefix), jgpt2.init_kv_cache(GCFG, 2, 12),
                                   return_hidden=True)
    tl, _, th = gpt2.gpt2_prefill(tp, GCFG, _t(prefix), gpt2.init_kv_cache(GCFG, 2, 12, device="cpu"),
                                  return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)
    x = rng.standard_normal((2, GCFG.n_embd)).astype(np.float32)
    jl, _, jh = jgpt2.gpt2_step(jp, GCFG, jnp.asarray(x), jcache, 4, return_hidden=True)
    tl, _, th = gpt2.gpt2_step(tp, GCFG, _t(x), tcache, 4, return_hidden=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)


def test_probe_equals_a_step_on_a_copy_of_the_cache():
    """Each candidate's probe logits and hidden state are ``gpt2_step``'s with
    that candidate written at ``index`` of a copy of the cache."""
    _, tp, _, tcache, rng = _prefilled(3)
    ids = torch.from_numpy(rng.integers(0, GCFG.vocab_size, (2, 5)))
    logits, _, hidden = gpt2.gpt2_probe_step(tp, GCFG, gpt2.gpt2_embed(tp, ids), tcache, 4)
    for j in range(5):
        copy = {k: v.clone() for k, v in tcache.items()}
        lj, _, hj = gpt2.gpt2_step(tp, GCFG, gpt2.gpt2_embed(tp, ids[:, j]), copy, 4,
                                   return_hidden=True)
        torch.testing.assert_close(logits[:, j], lj, atol=TOL, rtol=0)
        torch.testing.assert_close(hidden[:, j], hj, atol=TOL, rtol=0)


# --- the CLAP term ----------------------------------------------------------


def test_clap_logprobs_match_jax():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((3, 16)).astype(np.float32)
    text = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = np.asarray(jmagic._clap_logprobs_device(jnp.asarray(audio), jnp.asarray(text), 0.07))
    np.testing.assert_allclose(magic._clap_logprobs_device(_t(audio), _t(text), 0.07), want,
                               atol=1e-5)
    for b in range(3):
        np.testing.assert_array_equal(magic.clap_logprobs(audio[b], text[b], 0.07),
                                      jmagic.clap_logprobs(audio[b], text[b], 0.07))


# --- greedy MAGIC -----------------------------------------------------------


def _brute_magic(params, prefix, audio, score_fn, beam_width, alpha, beta, decoding_len, stop):
    """Full-recompute MAGIC (the JAX test's oracle, in the port's torch): no
    cache and no probe, every candidate's hidden state from a forward pass
    over the whole sequence, then the reference's score."""
    from zs_aac_tpu_torch.models.gpt2 import _block, _causal_bias, _ln, _logits

    def forward(emb):
        x = emb + params["wpe"][:emb.shape[1]][None]
        for blk in params["h"]:
            x, _ = _block(blk, GCFG, x, bias=_causal_bias(emb.shape[1], x.dtype, x.device))
        x = _ln(x, params["ln_f"], GCFG.layer_norm_epsilon)
        return _logits(x, params)[0], x[0]

    def unit(h):
        return h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)

    emb, generated = prefix, []
    for _ in range(decoding_len):
        logits, h_ctx = forward(emb)
        probs = torch.softmax(logits[-1], dim=-1).numpy()
        top = np.argsort(-probs, kind="stable")[:beam_width]
        scores = np.zeros(beam_width)
        for j, t in enumerate(top):
            _, h_all = forward(torch.cat([emb, params["wte"][int(t)][None, None]], dim=1))
            deg = float((unit(h_ctx.numpy()) @ unit(h_all[-1].numpy())).max())
            scores[j] = (1 - alpha) * probs[t] - alpha * deg
        scores = scores + beta * np.asarray(score_fn(audio, [generated + [int(t)] for t in top]))
        tok = int(top[int(np.argmax(scores))])
        generated.append(tok)
        emb = torch.cat([emb, params["wte"][tok][None, None]], dim=1)
        if tok == stop:
            break
    return generated


def test_magic_search_matches_jax_and_brute_force_oracle():
    """The inputs and additive fake encoder of the JAX package's oracle test
    (``tests/test_magic_and_drivers.py``), where JAX's ``magic_search``
    equals its full-recompute oracle; the port equals both."""
    jp, tp = _params(3)
    rng = np.random.default_rng(3)
    prefix = rng.standard_normal((1, 4, GCFG.n_embd)).astype(np.float32)
    audio = rng.standard_normal(16).astype(np.float32)
    emb_table = rng.standard_normal((50, 16)).astype(np.float32)

    def encode(texts):
        return np.stack([emb_table[[int(w[1:]) for w in s.split() if w.startswith("w")]].sum(0)
                         for s in texts])

    jscorer, tscorer = _scorers(encode)
    kw = dict(beam_width=5, alpha=0.1, beta=0.2, decoding_len=10, stop_token_id=STOP)
    got = magic.magic_search(tp, GCFG, _t(prefix), audio, tscorer, **kw)
    assert got == _brute_magic(tp, _t(prefix), audio, tscorer, 5, 0.1, 0.2, 10, STOP)
    assert got == jmagic.magic_search(jp, GCFG, jnp.asarray(prefix), audio, jscorer, **kw)
    assert len(got) == 10 or got[-1] == STOP


def test_magic_search_batched_matches_jax_and_single_clips():
    """Batch invariance with an early stop: a stop token that clip 0 emits
    third ends clip 0 while the others decode on."""
    jp, tp = _params(1)
    rng = np.random.default_rng(5)
    prefix = rng.standard_normal((6, 4, GCFG.n_embd)).astype(np.float32)
    audio = rng.standard_normal((6, 16)).astype(np.float32)
    jscorer, tscorer = _scorers()
    kw = dict(beam_width=5, alpha=0.1, beta=0.2, decoding_len=12)
    first = magic.magic_search_batched(tp, GCFG, _t(prefix), audio, tscorer,
                                       stop_token_id=STOP, **kw)
    stop2 = first[0][2]
    assert any(stop2 not in s[:3] for s in first[1:])
    for stop in (STOP, stop2):
        got = magic.magic_search_batched(tp, GCFG, _t(prefix), audio, tscorer,
                                         stop_token_id=stop, **kw)
        assert got == jmagic.magic_search_batched(jp, GCFG, jnp.asarray(prefix), audio, jscorer,
                                                  stop_token_id=stop, **kw)
        assert got == [magic.magic_search(tp, GCFG, _t(prefix[b:b + 1]), audio[b], tscorer,
                                          stop_token_id=stop, **kw) for b in range(6)]
    assert len(got[0]) == 3 and len({len(s) for s in got}) > 1


def _learned_captioner():
    """The committed tiny captioner (trained by the JAX CLIs): its GPT-2 in
    both packages, its word tokenizer and the test bank's embeddings."""
    import pickle

    from zs_aac_tpu.models.caption import CaptionConfig as JaxCaptionConfig
    from zs_aac_tpu.models.caption import caption_embeddings
    from zs_aac_tpu.train.train_prompt import _gpt2_config
    from zs_aac_tpu_torch.models.convert import _listify
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    saved = json.loads((FIXTURE_DIR / "params.json").read_text())
    with open(FIXTURE_DIR / "train.pkl", "rb") as f:
        corpus = [r["caption"] for r in pickle.load(f)] + ["there are something in this audio."]
    tok = WordTokenizer.from_corpus(corpus)
    tree = load_params(str(FIXTURE_DIR / "best.pth"))
    jtree = jax.tree.map(jnp.asarray, _listify(tree))
    ccfg = JaxCaptionConfig(prefix_length=4, prefix_size=32, clip_length=4,
                            gpt2=_gpt2_config("tiny", saved["gpt2_vocab_size"]))
    with open(FIXTURE_DIR / "test.pkl", "rb") as f:
        bank = np.stack([np.asarray(r["audio_embedding"], np.float32).reshape(-1)
                         for r in pickle.load(f)])
    emb = np.asarray(caption_embeddings(jtree, ccfg, jnp.asarray(bank)))
    return tok, ccfg.gpt2, jtree["gpt2"], from_jax_params(tree, device="cpu")["gpt2"], emb


def test_q8_probe_cache_on_the_learned_captioner():
    """The int8 probe cache gives the float cache's tokens on learned
    weights, in both packages (``tests/test_quantized_decode.py``'s neutral
    scorer: the LM and the degeneration penalty choose)."""
    tok, gcfg, jp, tp, emb = _learned_captioner()

    def score_fn(a, cand):
        return np.zeros(len(cand), np.float32)

    kw = dict(beam_width=4, alpha=0.1, beta=0.2, decoding_len=12,
              stop_token_id=tok.stop_token_id)
    audio = np.zeros(8, np.float32)
    for b in range(4):
        got_f = magic.magic_search(tp, gcfg, _t(emb[b:b + 1]), audio, score_fn, **kw)
        got_q = magic.magic_search(tp, gcfg, _t(emb[b:b + 1]), audio, score_fn, quant=True, **kw)
        assert got_q == got_f
        assert got_q == jmagic.magic_search(jp, gcfg, jnp.asarray(emb[b:b + 1]), audio, score_fn,
                                            quant=True, **kw)
        assert tok.decode(got_f).endswith(".")


# --- beam MAGIC -------------------------------------------------------------


def test_generate_beam_magic_batched_matches_single_clip_and_jax():
    jp, tp = _params(0)
    rng = np.random.default_rng(5)
    prefix = rng.standard_normal((3, 4, GCFG.n_embd)).astype(np.float32)
    audio = rng.standard_normal((3, 16)).astype(np.float32)
    jscorer, tscorer = _scorers()
    kw = dict(beam_size=3, magic_width=5, alpha=0.1, beta=0.2, entry_length=8)
    for stop in (STOP, None):
        if stop is None:    # a stop mid-sequence: stopped-row forcing
            stop = int(got_t[0][0][min(2, len(got_t[0][0]) - 1)])
        got_t, got_s = magic.generate_beam_magic_batched(tp, GCFG, _t(prefix), audio, tscorer,
                                                         stop_token_id=stop, **kw)
        want_t, want_s = jmagic.generate_beam_magic_batched(
            jp, GCFG, jnp.asarray(prefix), audio, jscorer, stop_token_id=stop, **kw)
        assert got_t == want_t
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
        for b in range(3):
            one_t, one_s = magic.generate_beam_magic(tp, GCFG, _t(prefix[b:b + 1]), audio[b],
                                                     tscorer, stop_token_id=stop, **kw)
            jone_t, jone_s = jmagic.generate_beam_magic(
                jp, GCFG, jnp.asarray(prefix[b:b + 1]), audio[b], jscorer, stop_token_id=stop,
                **kw)
            assert got_t[b] == one_t == jone_t, f"clip {b}"
            np.testing.assert_allclose(one_s, jone_s, rtol=1e-5)
            np.testing.assert_allclose(got_s[b], one_s, rtol=1e-5)
    assert any(len(c) < 8 for beams in got_t for c in beams)


# --- host tokenization ------------------------------------------------------


def _bpe_pair(corpus):
    jtok = _train_bpe(corpus)
    merges = sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get)
    return jtok, GPT2BPETokenizer(dict(jtok.encoder), merges)


def test_incremental_wordpiece_matches_full_retokenize_and_jax():
    """Id matrices of a long random decode: word merges, punctuation,
    multi-byte UTF-8 split over BPE tokens and the 28-piece truncation; and
    beam reorders."""
    corpus = ["a dog barks loudly in the park.",
              "rain falls, falling on the tin roof all night!",
              "café naïve déjà vu — piano",
              "the engine of a car revs and fades away."]
    jlm, lm = _bpe_pair(corpus)
    jwp = _char_wordpiece(corpus)
    wp = WordPieceTokenizer(jwp.itos)
    B, k = 3, 5
    rng = np.random.default_rng(0)
    incr = magic.IncrementalWordPiece(wp, lm, B)
    jincr = jmagic.IncrementalWordPiece(jwp, jlm, B)
    generated = [[] for _ in range(B)]
    for step in range(48):
        cands = rng.integers(0, lm.vocab_size, (B, k))
        got = incr.matrix([r for b in range(B) for r in incr.candidate_rows(b, cands[b])])
        texts = [lm.decode(generated[b] + [int(t)]) for b in range(B) for t in cands[b]]
        np.testing.assert_array_equal(got, magic.wordpiece_ids(wp, texts),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(
            got, jincr.matrix([r for b in range(B) for r in jincr.candidate_rows(b, cands[b])]))
        if step % 7 == 6:
            src = rng.integers(0, B, B)
            incr.reorder(src)
            jincr.reorder(src)
            generated = [list(generated[s]) for s in src]
        sel = rng.integers(0, k, B)
        for b in range(B):
            t = int(cands[b, sel[b]])
            generated[b].append(t)
            incr.commit(b, t)
            jincr.commit(b, t)


# --- the text tower ---------------------------------------------------------


def _clap_tree():
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    return load_params(str(TINY_CLAP_DIR / "ase.msgpack"))


def test_quantize_text_tower_int8_matches_jax():
    from zs_aac_tpu.models.bert_q8 import quantize_text_tower_int8 as jquant
    from zs_aac_tpu_torch.models.ase import text_config
    from zs_aac_tpu_torch.models.bert_q8 import quantize_text_tower_int8

    tree = _clap_tree()
    bcfg = text_config("bert-tiny-test")
    got = quantize_text_tower_int8(from_jax_params(tree, device="cpu"), bcfg)
    want = jquant(jax.tree.map(jnp.asarray, tree), bcfg)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.fixture
def staged_clap(tmp_path, monkeypatch):
    register_tiny_bert_in_jax(monkeypatch.setitem)
    return stage_tiny_captioner(tmp_path)["clap_ckpt"]


TEXTS = ["a dog barks in the yard.", "rain", "birds sing in the trees and a car horn blares",
         "a car horn blares loudly. a dog barks. rain falls on the roof. birds sing in the "
         "trees. the yard"]


@pytest.mark.parametrize("q8_tower", [False, True], ids=["float", "q8_tower"])
def test_text_tower_loader_matches_jax(staged_clap, q8_tower):
    """The msgpack + sidecar through both loaders: the same id upload (a
    30-token text reaches the 30 bucket) and the same embeddings (float:
    ``TOL``; the bf16 int8 tower: ``Q8_TOWER_TOL``)."""
    jenc = jmagic._load_ase_text_encoder(staged_clap, q8_tower=q8_tower)
    tenc = magic._load_ase_text_encoder(staged_clap, q8_tower=q8_tower, device="cpu")
    ids = magic.wordpiece_ids(tenc.device.wordpiece, TEXTS)
    np.testing.assert_array_equal(ids, jenc.device.tokenize(TEXTS))
    assert ids.shape[1] == 30
    np.testing.assert_allclose(tenc(TEXTS).numpy(), np.asarray(jenc(TEXTS)),
                               atol=Q8_TOWER_TOL if q8_tower else TOL)
    if q8_tower:   # the JAX package's own bound against the float tower
        float_embs = magic._load_ase_text_encoder(staged_clap, device="cpu")(TEXTS).numpy()
        assert (tenc(TEXTS).numpy() * float_embs).sum(-1).min() > 0.98


def test_text_tower_loader_reads_a_train_state(staged_clap, tmp_path):
    """``--clap_ckpt`` also takes a train state written by the port's
    training drivers (``save_train_state``), with the same sidecar."""
    import shutil
    import types

    from zs_aac_tpu_torch.utils.checkpoints import save_train_state

    variables = from_jax_params(_clap_tree(), device="cpu")
    path = str(tmp_path / "best_model.ckpt")
    save_train_state(path, types.SimpleNamespace(params=variables["params"],
                                                 batch_stats=variables["batch_stats"],
                                                 opt_state={}, step=3))
    shutil.copy(staged_clap + ".json", path + ".json")
    want = magic._load_ase_text_encoder(staged_clap, device="cpu")(TEXTS)
    torch.testing.assert_close(magic._load_ase_text_encoder(path, device="cpu")(TEXTS), want,
                               atol=0, rtol=0)


def test_q8_tower_is_refused_for_clip_and_gpt2_towers():
    with pytest.raises(ValueError, match="BERT-family"):
        magic.text_encoder({"params": {}}, "gpt2", None, q8_tower=True)


def test_scorer_through_the_loaded_tower_matches_jax(staged_clap):
    """make_magic_scorer's batched scores over the loaded tiny tower."""
    words = ["a", "dog", "barks", "rain", "falls", "the", "roof", "."]
    jscorer = jmagic.make_magic_scorer(staged_clap, JaxWordTokenizer(words))
    tscorer = magic.make_magic_scorer(staged_clap, WordTokenizer(words), device="cpu")
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 32)).astype(np.float32)
    cands = [[list(rng.integers(2, 9, n)) for n in (1, 2, 3, 4)] for _ in range(2)]
    np.testing.assert_allclose(tscorer.batched(audio, cands), jscorer.batched(audio, cands),
                               atol=1e-5)
    np.testing.assert_allclose(tscorer(audio[0], cands[0]), jscorer(audio[0], cands[0]),
                               atol=1e-5)


# --- the fixture ------------------------------------------------------------


CLAP_AUDIO_RECORD = TINY_CLAP_DIR / "audio_expected.json"


def jax_clap_audio_embeddings() -> np.ndarray:
    """The JAX package's eval-mode audio embeddings of ``clap_waves()`` through
    the committed CLAP checkpoint (``make_encode_fns``, the XLA log-mel at
    the default config: 32 kHz, n_fft 1024, hop 320, 64 mels)."""
    from zs_aac_tpu.models import ase as jase
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train.contrastive import make_encode_fns
    from zs_aac_tpu_torch.testdata import clap_waves
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    meta = json.loads((TINY_CLAP_DIR / "ase.msgpack.json").read_text())
    acfg = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["ase_config"].items()}
    saved = dict(jase.TEXT_MODEL_REGISTRY)
    register_tiny_bert_in_jax(dict.__setitem__)
    try:
        encode_audio, _ = make_encode_fns(jase.ASE(jase.ASEConfig(**acfg)), LogMelConfig(),
                                          mel_impl="xla")
        variables = jax.tree.map(jnp.asarray, load_params(str(TINY_CLAP_DIR / "ase.msgpack")))
        return np.asarray(encode_audio(variables, jnp.asarray(clap_waves())))
    finally:
        jase.TEXT_MODEL_REGISTRY.clear()
        jase.TEXT_MODEL_REGISTRY.update(saved)


def write_audio_record():
    """``tiny_clap/audio_expected.json`` from the committed checkpoint."""
    emb = jax_clap_audio_embeddings()
    CLAP_AUDIO_RECORD.write_text(json.dumps({"audio_embeddings": emb.tolist()}) + "\n")
    print(f"wrote {CLAP_AUDIO_RECORD}")


def write_fixture():
    """Write ``testdata/tiny_clap/`` (``ase.msgpack`` + ``.json``, the tiny
    ASE's ``vocab.txt``, the audio record) and record the
    JAX ``predict_prompt``'s MAGIC captions of the committed tiny captioner
    into its ``expected.json`` (the other keys and ``best.pth`` untouched).

    The JAX loader builds its parameter template from a (1, 64, 64)
    spectrogram, which the tiny HTSAT (16 mels) refuses; so the checkpoint
    pairs ``ase.pt``'s text tower and projection (through JAX
    ``convert_ase``) with a tiny Cnn14 audio tower (channels (4, 8), seeded
    init). MAGIC reads the text side only."""
    import shutil
    import tempfile

    from test_torch_bert_ase import ase_config_kwargs
    from test_torch_predict import MODES, _captions, _jax_predict, _mode_flags
    from zs_aac_tpu.models import ase as jase
    from zs_aac_tpu.models.convert import convert_ase
    from zs_aac_tpu.utils.checkpoints import save_params

    register_tiny_bert_in_jax(lambda d, k, v: d.__setitem__(k, v))
    sd = torch.load(TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    text_side = convert_ase(sd, jase.ASEConfig(**ase_config_kwargs()))["params"]
    acfg = dict(embed_size=32, audio_encoder="cnn14", audio_channels=(4, 8),
                text_model="bert-tiny-test", spec_augmentation=False)
    variables = jase.ASE(jase.ASEConfig(**acfg)).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False)
    variables = jax.tree.map(np.asarray, variables)
    params = {**variables["params"], **{k: text_side[k] for k in ("text_enc", "text_proj",
                                                                    "temp")}}
    TINY_CLAP_DIR.mkdir(exist_ok=True)
    path = TINY_CLAP_DIR / "ase.msgpack"
    save_params(str(path), {"params": params, "batch_stats": variables["batch_stats"]})
    sidecar = {"ase_config": {**acfg, "audio_channels": list(acfg["audio_channels"])},
               "bert_tokenizer": "vocab.txt"}
    (TINY_CLAP_DIR / "ase.msgpack.json").write_text(json.dumps(sidecar, indent=1))
    shutil.copy(TINY_ASE_DIR / "vocab.txt", TINY_CLAP_DIR / "vocab.txt")

    expected = json.loads((FIXTURE_DIR / "expected.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        for mode in MODES:
            if mode.startswith("magic"):
                staged = stage_tiny_captioner(os.path.join(tmp, mode))
                _jax_predict(staged["run_dir"], staged["test_bank"],
                             _mode_flags(mode, staged["clap_ckpt"]))
                expected[mode] = _captions(staged["run_dir"])
    (FIXTURE_DIR / "expected.json").write_text(json.dumps(expected, indent=1, sort_keys=True))
    print(f"wrote {path} and the MAGIC keys of {FIXTURE_DIR / 'expected.json'}")
    write_audio_record()


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixture()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_magic.py --write-fixture")
