"""The port's ``predict_prompt`` (greedy and ``--isbeam``, float and
``--q8``, with and without ``--sound_effect`` hard prompts) against the JAX
package's, and the committed tiny-captioner fixture.

A run dir is made with the JAX package's own CLIs (``train_prompt`` on
a small synthetic zero-shot bank: four sound clusters, one caption each,
trained to convergence). Both packages' ``predict_prompt`` then run on copies of it, and
``output.txt`` (captions and nearest-vocab prefixes) and ``scores.txt``
must be identical. The committed fixture (``zs_aac_tpu_torch/testdata``,
the same recipe, run once) must still give its recorded captions from
both packages. The port's msgpack reader must load ``best.pth`` to the
arrays flax loads, and its parser must take every option of the JAX
package's.

Regenerate the committed fixture with
``PYTHONPATH=. python tests/test_torch_predict.py --write-fixture``; record
the JAX package's captions of new modes on the committed run dir, without
retraining (every other key and ``best.pth`` stay as they are), with
``PYTHONPATH=. python tests/test_torch_predict.py --record-modes MODE ...``.
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from zs_aac_tpu_torch.testdata import FIXTURE_DIR, stage_tiny_captioner

torch.set_num_threads(2)

CAPTIONS = [
    "a dog barks in the yard.",
    "rain falls on the roof.",
    "a car horn blares loudly.",
    "birds sing in the trees.",
]
E = 32  # CLAP-like embedding width of the synthetic banks


def _cluster(rng, k, noise=0.05):
    c = np.zeros(E, np.float32)
    c[k * 8:(k + 1) * 8] = 1.0
    return (c + noise * rng.standard_normal(E)).astype(np.float32)[None]


def make_tiny_run(root):
    """Banks + a converged tiny captioner trained by the JAX ``train_prompt`` CLI.
    Returns (run_dir, train_bank, test_bank)."""
    from zs_aac_tpu.train.train_prompt import main as train_main

    os.makedirs(root, exist_ok=True)
    r = np.random.default_rng(0)
    train = []
    for i in range(128):
        emb = _cluster(r, i % 4)
        train.append({"audio_id": f"train{i}", "caption": CAPTIONS[i % 4],
                      "text_embedding": emb, "audio_embedding": emb})
    test = [{"audio_id": f"clip{i}", "audio_embedding": _cluster(r, i % 4),
             "caption": [{"caption": CAPTIONS[i % 4]},
                         {"caption": CAPTIONS[(i + 1) % 4]}]} for i in range(12)]
    train_bank, test_bank = os.path.join(root, "train.pkl"), os.path.join(root, "test.pkl")
    for path, recs in ((train_bank, train), (test_bank, test)):
        with open(path, "wb") as f:
            pickle.dump(recs, f)   # a pickled list: no caption-length filter
    run_dir = train_main([
        "--data", train_bank, "--valdata", test_bank,
        "--out_dir", os.path.join(root, "runs"),
        "--bs", "32", "--epochs", "40", "--warmup", "2", "--lr", "3e-3",
        "--val_interval", "1000000", "--gpt2_size", "tiny", "--prefix_dim", str(E),
        "--prefix_length", "4", "--prefix_length_clip", "4",
    ])
    return run_dir, train_bank, test_bank


# the decode modes of the fixture and their flags; MAGIC's CLAP checkpoint is
# the committed tiny one (staged by ``stage_tiny_captioner``), and its width 5
# fits the tiny captioner's 24-word vocabulary
MAGIC = ["--magic", "--magic_width", "5"]
MODES = {"greedy": [], "q8": ["--q8"], "beam": ["--isbeam"], "beam_q8": ["--isbeam", "--q8"],
         "beam_bf16_softmax": ["--isbeam", "--bf16_softmax"],
         "beam_q8_bf16_softmax": ["--isbeam", "--q8", "--bf16_softmax"],
         "magic": MAGIC, "magic_beam": MAGIC + ["--isbeam"], "magic_q8": MAGIC + ["--q8"],
         "magic_q8_tower": MAGIC + ["--q8_tower"]}


def _mode_flags(mode, clap_ckpt):
    return MODES[mode] + (["--clap_ckpt", clap_ckpt] if mode.startswith("magic") else [])


def _jax_predict(run_dir, bank, flags):
    from zs_aac_tpu.train.predict_prompt import main

    main(["--test_dir", run_dir, "--data", bank] + flags)


def _port_predict(run_dir, bank, flags):
    from zs_aac_tpu_torch.train.predict_prompt import main

    main(["--test_dir", run_dir, "--data", bank, "--device", "cpu"] + flags)


def _outputs(run_dir):
    with open(os.path.join(run_dir, "output.txt")) as f:
        preds = json.load(f)["predictions"]
    with open(os.path.join(run_dir, "scores.txt")) as f:
        return preds, f.read()


def _captions(run_dir):
    return {p["filename"]: p["caption"] for p in _outputs(run_dir)[0]}


@pytest.fixture(scope="module")
def fresh_run(tmp_path_factory):
    return make_tiny_run(str(tmp_path_factory.mktemp("tiny_run")))


@pytest.fixture
def jax_knows_the_tiny_bert(monkeypatch):
    """The tiny CLAP checkpoint's text model, ``bert-tiny-test``, is in the
    port's registry only."""
    from test_torch_bert_ase import register_tiny_bert_in_jax

    register_tiny_bert_in_jax(monkeypatch.setitem)


def _both_predict(run_dir, test_bank, tmp_path, flags):
    runs = {}
    for side, predict in (("jax", _jax_predict), ("port", _port_predict)):
        runs[side] = str(tmp_path / side)
        shutil.copytree(run_dir, runs[side])
        predict(runs[side], test_bank, flags)
    return runs


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_outputs_identical_to_jax(fresh_run, tmp_path, mode, jax_knows_the_tiny_bert):
    run_dir, _, test_bank = fresh_run
    clap = stage_tiny_captioner(tmp_path / "fixture")["clap_ckpt"]
    runs = _both_predict(run_dir, test_bank, tmp_path, _mode_flags(mode, clap))
    jax_preds, jax_scores = _outputs(runs["jax"])
    port_preds, port_scores = _outputs(runs["port"])
    assert len(port_preds) == 12
    assert port_preds == jax_preds
    assert port_scores == jax_scores
    with open(os.path.join(runs["port"], "timing.json")) as f:
        timing = json.load(f)
    assert {"setup_s", "decode_s", "chunk_walls_s", "eval_and_write_s",
            "total_s", "n_clips"} <= set(timing) and timing["n_clips"] == 12


@pytest.mark.parametrize("mode", list(MODES))
def test_committed_fixture_captions(tmp_path, mode, jax_knows_the_tiny_bert):
    for side, predict in (("jax", _jax_predict), ("port", _port_predict)):
        staged = stage_tiny_captioner(tmp_path / side)
        predict(staged["run_dir"], staged["test_bank"], _mode_flags(mode, staged["clap_ckpt"]))
        assert _captions(staged["run_dir"]) == staged["expected"][mode], side
    assert set(staged["expected"][mode].values()) == set(CAPTIONS)


# An AudioSet-style label bank: each clip's three nearest labels become its
# hard prompt ("There are dog, rain, car horn in this audio."); "wind" is in
# no caption, so its words are unknown to the word tokenizer.
LABELS = ["dog", "rain", "car horn", "birds", "wind"]


def _write_label_bank(path):
    r = np.random.default_rng(7)
    records = [{"label": name, "label_id": i,
                "label_embedding": _cluster(r, i, noise=0.3) if i < 4
                else r.standard_normal((1, E)).astype(np.float32)}
               for i, name in enumerate(LABELS)]
    with open(path, "wb") as f:
        pickle.dump(records, f)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_sound_effect_outputs_identical_to_jax(fresh_run, tmp_path, mode):
    run_dir, _, test_bank = fresh_run
    bank = str(tmp_path / "labels.pkl")
    _write_label_bank(bank)
    runs = _both_predict(run_dir, test_bank, tmp_path, MODES[mode] + ["--sound_effect", bank])
    jax_preds, jax_scores = _outputs(runs["jax"])
    port_preds, port_scores = _outputs(runs["port"])
    assert len(port_preds) == 12
    assert port_preds == jax_preds
    assert port_scores == jax_scores


@pytest.mark.parametrize("flags,chunks", [(["--batch", "512"], [256, 44]),
                                          (["--batch", "256", "--isbeam"], [64, 64, 64, 64, 44])])
def test_timing_counts_the_clips_each_chunk_held(tmp_path, flags, chunks):
    """``timing.json``'s steady clips/s counts each timed chunk's clips
    (greedy chunks hold at most 256, beam 64), not ``--batch`` clips."""
    import pickle

    staged = stage_tiny_captioner(tmp_path)
    with open(staged["test_bank"], "rb") as f:
        records = pickle.load(f)
    bank = str(tmp_path / "big.pkl")
    with open(bank, "wb") as f:
        pickle.dump([dict(r, audio_id=f"{r['audio_id']}_{i}")
                     for i in range(25) for r in records], f)    # 300 clips
    _port_predict(staged["run_dir"], bank, flags)
    with open(os.path.join(staged["run_dir"], "timing.json")) as f:
        timing = json.load(f)
    assert timing["n_clips"] == 300 and timing["chunk_clips"] == chunks
    walls = timing["chunk_walls_s"]
    assert timing["decode_steady_clips_per_s"] == round(sum(chunks[1:]) / sum(walls[1:]), 1)


def test_parser_takes_every_option_of_the_jax_parser(tmp_path):
    from zs_aac_tpu.train.predict_prompt import build_parser as jax_parser
    from zs_aac_tpu_torch.train.predict_prompt import build_parser

    port = build_parser()
    want = jax_parser()
    options = [a for a in want._actions if a.option_strings and a.dest != "help"]
    assert len(options) == 15
    for action in options:
        argv = ["--test_dir", "x", "--data", "y"]
        if action.dest not in ("test_dir", "data"):
            argv.append(action.option_strings[0])
            if action.nargs != 0:
                argv.append("1")
        got = port.parse_args(argv)
        assert vars(got)[action.dest] == vars(want.parse_args(argv))[action.dest], action.dest
    defaults = vars(want.parse_args(["--test_dir", "x", "--data", "y"]))
    assert {k: v for k, v in vars(port.parse_args(["--test_dir", "x", "--data", "y"])).items()
            if k != "device"} == defaults


def test_msgpack_reader_matches_flax():
    import jax
    from flax import serialization

    from zs_aac_tpu_torch.utils.checkpoints import load_params, msgpack_unpackb

    path = FIXTURE_DIR / "best.pth"
    want = serialization.msgpack_restore(path.read_bytes())
    got = load_params(str(path))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the other msgpack forms flax's writer can emit
    obj = {"i": [0, 127, 128, 65536, 2**40, -1, -33, -200, -2**40],
           "f": np.float32(1.5), "d": 2.25, "s": "x" * 40, "n": None, "t": True,
           "a": np.arange(6, dtype=np.int8).reshape(2, 3),
           "big": {str(k): k for k in range(20)}}
    back = msgpack_unpackb(serialization.to_bytes(obj))
    ref = serialization.msgpack_restore(serialization.to_bytes(obj))
    np.testing.assert_array_equal(back.pop("a"), ref.pop("a"))
    assert back == ref


def write_fixture():
    """Regenerate ``zs_aac_tpu_torch/testdata/tiny_captioner``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        run_dir, train_bank, test_bank = make_tiny_run(tmp)
        expected = {}
        clap = stage_tiny_captioner(os.path.join(tmp, "fixture"))["clap_ckpt"]
        for mode in MODES:
            d = os.path.join(tmp, mode)
            shutil.copytree(run_dir, d)
            _jax_predict(d, test_bank, _mode_flags(mode, clap))
            expected[mode] = _captions(d)
        out = FIXTURE_DIR
        os.makedirs(out, exist_ok=True)
        shutil.copy(os.path.join(run_dir, "best.pth"), out / "best.pth")
        shutil.copy(test_bank, out / "test.pkl")
        with open(train_bank, "rb") as f:   # the tokenizer needs only captions
            captions = [{"caption": rec["caption"]} for rec in pickle.load(f)]
        with open(out / "train.pkl", "wb") as f:
            pickle.dump(captions, f)
        with open(os.path.join(run_dir, "params.json")) as f:
            params = json.load(f)
        params.update(data=["train.pkl"], valdata="test.pkl", out_dir="runs",
                      output_dir="runs/tiny")
        (out / "params.json").write_text(json.dumps(params, indent=1, sort_keys=True))
        (out / "expected.json").write_text(json.dumps(expected, indent=1, sort_keys=True))
    print(f"wrote {out}: {sorted(os.listdir(out))}")


def record_modes(modes):
    """Record the JAX ``predict_prompt``'s captions of ``modes`` on the
    committed run dir into its ``expected.json``."""
    import tempfile

    expected = json.loads((FIXTURE_DIR / "expected.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        for mode in modes:
            staged = stage_tiny_captioner(os.path.join(tmp, mode))
            _jax_predict(staged["run_dir"], staged["test_bank"],
                         _mode_flags(mode, staged["clap_ckpt"]))
            expected[mode] = _captions(staged["run_dir"])
    (FIXTURE_DIR / "expected.json").write_text(json.dumps(expected, indent=1, sort_keys=True))
    print(f"recorded {modes} into {FIXTURE_DIR / 'expected.json'}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"] or sys.argv[1:2] == ["--record-modes"]:
        os.environ["JAX_PLATFORMS"] = "cpu"
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from test_torch_bert_ase import register_tiny_bert_in_jax

        register_tiny_bert_in_jax(lambda d, k, v: d.__setitem__(k, v))
        if sys.argv[1] == "--write-fixture":
            write_fixture()
        elif sys.argv[2:] and set(sys.argv[2:]) <= set(MODES):
            record_modes(sys.argv[2:])
        else:
            sys.exit(f"--record-modes takes modes of {list(MODES)}")
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_predict.py --write-fixture | "
                 "--record-modes MODE ...")
