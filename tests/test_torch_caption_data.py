"""The port's caption datasets, prompts, banks and related-caption k-NN
against the JAX package.

The host code is a copy, so the comparisons are exact: dataset items and
``caption_batches`` bitwise equal (same records, same ``random.Random`` and
``np.random.default_rng`` draws in the same order), bank files read across
packages to equal records, and the related captions' neighbour sets equal
to the JAX host path's (random embeddings: no ties).
"""

import pickle
import random

import numpy as np
import pytest
import torch

from zs_aac_tpu.data import banks as jb
from zs_aac_tpu.data import datasets as jd
from zs_aac_tpu.data import prompts as jp
from zs_aac_tpu.data.tokenizer import WordTokenizer as JWordTokenizer
from zs_aac_tpu_torch.data import banks as tb
from zs_aac_tpu_torch.data import datasets as td
from zs_aac_tpu_torch.data import prompts as tp
from zs_aac_tpu_torch.data.tokenizer import WordTokenizer as TWordTokenizer

torch.set_num_threads(2)

E = 16
WORDS = "dog rain car bird wind horn water people engine music door bell".split()
LABELS = ["Speech", "Dog", "Rain", "Vehicle", "Bird", "Music", "Wind", "Bell"]


def _caption(r, n):
    return " ".join(WORDS[i] for i in r.integers(0, len(WORDS), n))


def _record(r, i, n_words):
    rec = {"audio_id": f"a{i}", "caption": _caption(r, n_words),
           "text_embedding": r.standard_normal((1, E)).astype(np.float32),
           "audio_embedding": r.standard_normal((1, E)).astype(np.float32),
           "related_embeddings": r.standard_normal((5, E)).astype(np.float32)}
    if i % 3 == 0:
        rec["cn_caption"] = _caption(r, 4)
    if i % 4 == 1:
        rec["fr_caption"] = _caption(r, 5)
    return rec


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """A streamed bank (caption lengths 3..24 words, so the 8-20 filter cuts
    some), a list bank (kept whole), a label bank and the corpus."""
    root = tmp_path_factory.mktemp("banks")
    r = np.random.default_rng(0)
    stream = [_record(r, i, int(r.integers(3, 25))) for i in range(40)]
    listed = [_record(r, 100 + i, int(r.integers(3, 25))) for i in range(12)]
    labels = [{"label": name, "label_embedding": r.standard_normal((1, E)).astype(np.float32),
               "label_id": j} for j, name in enumerate(LABELS)]
    paths = {"stream": str(root / "stream.pkl"), "list": str(root / "list.pkl"),
             "labels": str(root / "labels.pkl")}
    with open(paths["stream"], "wb") as f:
        for rec in stream:
            pickle.dump(rec, f)
    for key, recs in (("list", listed), ("labels", labels)):
        with open(paths[key], "wb") as f:
            pickle.dump(recs, f)
    corpus = [rec["caption"] for rec in stream + listed] + [
        "there are something in this audio.", " ".join(LABELS)]
    return paths, corpus


def _same(a, b):
    """Bitwise equality of two items or batches (dicts of arrays)."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


CONFIGS = {
    "text_prefix": dict(),
    "percentage_half": dict(percentage=0.5),
    "percentage_count": dict(percentage=7),
    "audio_normalized": dict(use_audio_embedding=True, normalize_prefix=True),
    "related": dict(use_related_text=True),
    "hard_prompts_masked": dict(mask_probability=0.5, sound_effect_k=3),
    "multilingual": dict(multilingual=True, use_related_text=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_items_and_batches_bitwise_equal_to_jax(banks, name):
    paths, corpus = banks
    kw = dict(CONFIGS[name], prefix_length=4, max_seq_len=12, seed=3)
    if name.startswith("hard"):
        kw["sound_effect_path"] = paths["labels"]
    data = [paths["stream"], paths["list"]]
    jds = jd.CaptionBankDataset(data, JWordTokenizer.from_corpus(corpus),
                                jd.CaptionDatasetConfig(**kw))
    tds = td.CaptionBankDataset(data, TWordTokenizer.from_corpus(corpus),
                                td.CaptionDatasetConfig(**kw))
    assert len(tds) == len(jds)
    assert [r["audio_id"] for r in tds.records] == [r["audio_id"] for r in jds.records]
    for i in range(len(jds)):
        _same(tds[i], jds[i])
    for epoch in range(2):
        got = list(td.caption_batches(tds, 4, shuffle=True, seed=epoch))
        want = list(jd.caption_batches(jds, 4, shuffle=True, seed=epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)
    tail = list(td.caption_batches(tds, 5, shuffle=False, drop_last=False))
    want_tail = list(jd.caption_batches(jds, 5, shuffle=False, drop_last=False))
    assert len(tail) == len(want_tail)
    for g, w in zip(tail, want_tail):
        _same(g, w)


def test_word_filter_applies_to_streamed_records_only(banks):
    paths, corpus = banks
    tok = TWordTokenizer.from_corpus(corpus)
    recs = td._load_records([paths["stream"], paths["list"]], (8, 20))
    with open(paths["list"], "rb") as f:
        listed = pickle.load(f)
    streamed = [r for r in recs if r["audio_id"] not in {x["audio_id"] for x in listed}]
    assert streamed and all(8 <= len(r["caption"].split()) <= 20 for r in streamed)
    assert len(recs) - len(streamed) == len(listed)
    assert any(not 8 <= len(r["caption"].split()) <= 20 for r in listed)
    _records_equal(recs, jd._load_records([paths["stream"], paths["list"]], (8, 20)))
    ds = td.CaptionBankDataset([paths["stream"]], tok, td.CaptionDatasetConfig())
    assert len(ds) == len(streamed)


def test_test_dataset_matches_jax(banks, tmp_path):
    paths, corpus = banks
    r = np.random.default_rng(4)
    test = [{"audio_id": f"t{i}", "audio_embedding": r.standard_normal((1, E)).astype(np.float32),
             "caption": [{"caption": "A Dog barks"}, {"caption": "rain"}]} for i in range(5)]
    path = str(tmp_path / "test.pkl")
    tb.write_bank_list(path, test)
    kw = dict(prefix_length=4, normalize_prefix=True, sound_effect_path=paths["labels"])
    jt = jd.CaptionBankTestDataset(path, JWordTokenizer.from_corpus(corpus),
                                   jd.CaptionDatasetConfig(**kw))
    tt = td.CaptionBankTestDataset(path, TWordTokenizer.from_corpus(corpus),
                                   td.CaptionDatasetConfig(**kw))
    assert tt.references() == jt.references()
    for i in range(len(jt)):
        a, b = tt[i], jt[i]
        assert a.pop("audio_id") == b.pop("audio_id")
        _same(a, b)


def test_prompt_functions_match_jax(banks):
    _, corpus = banks
    jtok, ttok = JWordTokenizer.from_corpus(corpus), TWordTokenizer.from_corpus(corpus)
    for p in (0.0, 0.3, 0.7):
        for seed in range(4):
            assert tp.entities_process(LABELS, p, random.Random(seed)) == \
                jp.entities_process(LABELS, p, random.Random(seed))
            got = tp.parse_entities(ttok, LABELS[:4], p, random.Random(seed))
            want = jp.parse_entities(jtok, LABELS[:4], p, random.Random(seed))
            assert got.dtype == want.dtype and np.array_equal(got, want)
    for ents in ([], ["Dog"], LABELS[:3]):
        assert np.array_equal(tp.compose_discrete_prompts(ttok, ents),
                              jp.compose_discrete_prompts(jtok, ents))
    # the dataset module still hands out the composer
    assert td.compose_discrete_prompts is tp.compose_discrete_prompts
    hp = [np.arange(1, n + 1) for n in (3, 7, 1)]
    for max_length in (None, 5):
        for g, w in zip(tp.padding_captions(hp, max_length), jp.padding_captions(hp, max_length)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], np.ndarray) or isinstance(y[k], np.ndarray):
                assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k
            else:
                assert x[k] == y[k], k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bank_files_round_trip_across_packages(banks, tmp_path, writer):
    paths, _ = banks
    recs = tb.read_bank(paths["stream"])[:9]
    w, r = (tb, jb) if writer == "port" else (jb, tb)
    stream = str(tmp_path / "s.pkl")
    assert w.write_bank_stream(stream, recs[:5]) == 5
    assert w.write_bank_stream(stream, recs[5:], append=True) == 4
    _records_equal(r.read_bank(stream), recs)
    _records_equal(list(r.iter_bank(stream)), recs)
    # the columnar format holds records of one set of keys
    recs = [{k: v for k, v in rec.items() if k not in ("cn_caption", "fr_caption")}
            for rec in recs]
    npz = str(tmp_path / "b.npz")
    w.save_bank_npz(npz, recs)
    loaded = r.load_bank_npz(npz)
    assert len(loaded) == len(recs)
    for got, rec in zip(loaded, recs):
        assert got["caption"] == rec["caption"]
        assert np.array_equal(got["text_embedding"], rec["text_embedding"])
        assert np.array_equal(got["related_embeddings"], rec["related_embeddings"])
    _records_equal(tb.load_bank_npz(npz), jb.load_bank_npz(npz))


@pytest.mark.parametrize("device", ["cpu", None])
def test_attach_related_matches_jax_host_path(banks, device):
    from zs_aac_tpu.pipeline import related as jr
    from zs_aac_tpu_torch.pipeline import related as tr

    paths, _ = banks
    bank, records = tr.load_unique_text_embeddings([paths["stream"], paths["list"]])
    jbank, jrecords = jr.load_unique_text_embeddings([paths["stream"], paths["list"]])
    assert np.array_equal(bank, jbank) and len(records) == len(jrecords) == 52
    got = list(tr.attach_related(bank, records, 5, batch=16, device=device))
    want = list(jr.attach_related(jbank, jrecords, 5, batch=16, device=False))
    _records_equal(got, want)
    assert all(g["related_embeddings"].shape == (5, E) for g in got)


def test_related_main_writes_the_jax_records(banks, tmp_path):
    from zs_aac_tpu.pipeline import related as jr
    from zs_aac_tpu_torch.pipeline import related as tr

    paths, _ = banks
    args = ["--input_path", paths["stream"], paths["list"], "--topnumber", "3", "--batch", "20"]
    out_t, out_j = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    assert tr.main(args + ["--output_path", out_t, "--device", "cpu"]) == 52
    jr.main(args + ["--output_path", out_j])
    _records_equal(tb.read_bank(out_t), jb.read_bank(out_j))
    # appends, as the reference does
    tr.main(args + ["--output_path", out_t, "--device", "cpu"])
    assert len(tb.read_bank(out_t)) == 104
