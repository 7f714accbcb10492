"""The port's host pipeline against the JAX package's: ``pipeline/prepare.py``
(Clotho v1 and v2, AudioCaps) and ``pipeline/synthesize.py`` (its functions
and its three CLI modes), with no network call.

``prepare`` is held byte for byte: each package's ``main`` writes into the
same output path in turn (the manifests hold absolute link paths), and the
``wav.csv``/``text.json`` bytes and the symlink farm's names and targets
must be equal. The annotation tables carry the cells pandas treats
specially: quoted commas, doubled quotes, a tab, non-ASCII text, an empty
cell and a blank line; the output path holds a tab and a quote, which the
TSV must quote as pandas does.
"""

import csv
import os
import pickle
import random
import shutil

import numpy as np
import pytest

from zs_aac_tpu.pipeline import prepare as jprep
from zs_aac_tpu.pipeline import synthesize as jsyn
from zs_aac_tpu_torch.pipeline import prepare as tprep
from zs_aac_tpu_torch.pipeline import synthesize as tsyn

CAPTIONS = ["a dog barks, then stops.", 'rain on a "tin" roof.', "wind\tthrough trees.",
            "un café crème, s'il vous plaît.", "", "birds sing loudly in the park."]


def _write_csv(path, header, rows, delimiter=","):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=delimiter, lineterminator="\n")
        w.writerow(header)
        for i, r in enumerate(rows):
            w.writerow(r)
            if i == 1:
                f.write("\n")               # a blank line, which pandas skips


def clotho_tree(root, version):
    splits = ["dev", "eval"] if version == 1 else ["dev", "val", "eval"]
    for s, split in enumerate(splits):
        rows = []
        for i in range(4):
            name = f"{split} clip, {i}.wav"
            (root / "audio" / split).mkdir(parents=True, exist_ok=True)
            (root / "audio" / split / name).write_bytes(b"RIFF")
            rows.append([name] + [CAPTIONS[(i + j + s) % len(CAPTIONS)] for j in range(5)])
        _write_csv(root / "annotation" / f"{split}.csv",
                   ["file_name"] + [f"caption_{j}" for j in range(1, 6)], rows)


def audiocaps_tree(root):
    wavs = []
    for i in range(5):
        yt = f"yt{i:09d}"
        path = root / "audioset" / f"{yt}_30000.wav"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"RIFF")
        wavs.append([str(path), 10])
    _write_csv(root / "wavs.tsv", ["file_name", "duration"], wavs, delimiter="\t")
    for s, split in enumerate(["train", "val", "test"]):
        rows = [[100 * s + i, f"yt{(i + s) % 7:09d}", CAPTIONS[i % len(CAPTIONS)]]
                for i in range(8)]
        _write_csv(root / "annotation" / f"{split}.csv", ["audiocap_id", "youtube_id", "caption"],
                   rows)
    return root / "wavs.tsv"


def _snapshot(out):
    files, links = {}, {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, out)
            if os.path.islink(p):
                links[rel] = os.readlink(p)
            else:
                files[rel] = open(p, "rb").read()
    return files, links


def _both(argv, out):
    jprep.main(argv)
    want = _snapshot(out)
    shutil.rmtree(out)
    tprep.main(argv)
    return _snapshot(out), want


@pytest.mark.parametrize("version", [1, 2])
def test_prepare_clotho_is_byte_identical_to_jax(tmp_path, version):
    root = tmp_path / "clotho"
    clotho_tree(root, version)
    out = tmp_path / 'o"u\tt'
    (got_files, got_links), (want_files, want_links) = _both(
        ["clotho", str(root), str(out), "--version", str(version)], out)
    n_splits = 2 if version == 1 else 3
    assert len(want_files) == 2 * n_splits and len(want_links) == 4 * n_splits
    assert got_files == want_files
    assert got_links == want_links
    assert b'"' in want_files["dev/wav.csv"] and b"NaN" in want_files["dev/text.json"]


def test_prepare_audiocaps_is_byte_identical_to_jax(tmp_path):
    root = tmp_path / "audiocaps"
    tsv = audiocaps_tree(root)
    out = tmp_path / "out"
    (got_files, got_links), (want_files, want_links) = _both(
        ["audiocaps", str(root / "annotation"), str(out), "--audioset_csv", str(tsv)], out)
    assert len(want_links) == 15      # 5 clips x 3 splits; two ids have no wav
    assert got_files == want_files
    assert got_links == want_links
    assert b'"nan"' in want_files["train/text.json"]


# --- synthesize -------------------------------------------------------------------


def _embs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((10, 8)) + 10
    b = rng.standard_normal((10, 8)) - 10
    return np.concatenate([a, b]).astype(np.float32)


def fake_llm(prompt):
    n = len(prompt) % 7
    return f"1. a dog barks {n} times.\n- rain falls on the roof.\nxy\n  3) wind blows hard"


def test_synthesize_functions_match_jax():
    embs = _embs()
    for seed in range(5):
        assert (tsyn.select_diverse_examples(embs, 0.3, 3, random.Random(seed))
                == jsyn.select_diverse_examples(embs, 0.3, 3, random.Random(seed)))
    caps = [f"caption {i}" for i in range(20)]
    got = tsyn.synthesize_captions(fake_llm, embs, caps, 7, per_call=3, rng=random.Random(1))
    want = jsyn.synthesize_captions(fake_llm, embs, caps, 7, per_call=3, rng=random.Random(1))
    assert got == want and len(got) == 7

    def failing(prompt):
        raise ConnectionError("no route to host")

    assert (tsyn.synthesize_captions(failing, embs, caps, 2, rng=random.Random(2))
            == jsyn.synthesize_captions(failing, embs, caps, 2, rng=random.Random(2)))
    vocab = {"a", "dog", "barks", "the", "rain"}
    texts = ["a dog barks.", "a zebra gallops.", "the rain!", "", "A Dog Barks"]
    assert tsyn.vocabulary_filter(texts, vocab) == jsyn.vocabulary_filter(texts, vocab)
    recs = [{"caption": "a dog barks."}, {"caption": "rain.", "audio_id": "x"}]
    assert (tsyn.translate_records(recs, fake_llm) == jsyn.translate_records(recs, fake_llm))
    assert tsyn.generation_prompt(caps[:3], 5) == jsyn.generation_prompt(caps[:3], 5)
    assert tsyn.translation_prompt("x", "zh") == jsyn.translation_prompt("x", "zh")


@pytest.mark.parametrize("mode", ["generate", "filter", "translate"])
def test_synthesize_cli_modes_match_jax(tmp_path, monkeypatch, mode):
    for mod in (jsyn, tsyn):
        monkeypatch.setattr(mod, "_openai_caller", lambda model="gpt-3.5-turbo": fake_llm)
        monkeypatch.setattr(mod, "_deepl_caller", lambda: fake_llm)
    embs = _embs()
    bank = tmp_path / "bank.pkl"
    with open(bank, "wb") as f:
        pickle.dump([{"caption": f"caption {i}", "text_embedding": embs[i][None],
                      "audio_id": f"a{i}"} for i in range(len(embs))], f)
    (tmp_path / "caps.txt").write_text("a dog barks.\na zebra gallops.\n\nthe rain.\n")
    (tmp_path / "train.txt").write_text("A dog barks in the rain.\nthe wind\n")
    outs = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        out = tmp_path / f"{name}.out"
        argv = {"generate": [mode, "--bank", str(bank), "--total", "5"],
                "filter": [mode, "--captions_txt", str(tmp_path / "caps.txt"),
                           "--train_captions_txt", str(tmp_path / "train.txt")],
                "translate": [mode, "--bank", str(bank), "--engine", "deepl"]}[mode]
        random.seed(3)                       # generate's selection draws from `random`
        mod.main(argv + ["--out", str(out)])
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"] and len(outs["jax"]) > 10
    if mode == "translate":
        from zs_aac_tpu_torch.data.banks import read_bank

        recs = read_bank(str(tmp_path / "port.out"))
        assert len(recs) == 20 and recs[3]["fr_caption"] == fake_llm(
            tsyn.translation_prompt("caption 3", "fr"))


def test_synthesize_callers_say_what_is_missing(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "openai", None)
    with pytest.raises(RuntimeError, match="'openai' package"):
        tsyn._openai_caller()
    monkeypatch.setitem(sys.modules, "deepl", type(sys)("deepl"))
    monkeypatch.delenv("DEEPL_AUTH_KEY", raising=False)
    with pytest.raises(RuntimeError, match="DEEPL_AUTH_KEY"):
        tsyn._deepl_caller()
