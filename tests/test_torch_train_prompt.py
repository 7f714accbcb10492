"""The port's captioner train driver against the JAX package's, on the CPU.

- ``save_params`` writes the bytes flax writes for the same tree, JAX
  ``load_params`` restores them into the JAX package's own template (strict
  keys) with bitwise-equal leaves, and the port reads them back unchanged:
  MLP and Transformer mappers, with and without the sound-effect MLP.
- Both ``train_prompt`` drivers start from one JAX-written init
  (``--ckpt_file``) on the same banks at noise 0: their ``last.pth`` and
  ``best.pth`` agree within 1e-5 and their validation CIDEr columns are
  identical. (The attention key biases' exact gradient is 0, and each
  package computes rounding noise there, which Adam scales towards the
  learning rate: at ``--lr 3e-3`` they part by 1.8e-5, so the runs use 1e-3.)
- Both packages' ``predict_prompt`` read the port-written run dir and give
  the same captions, greedy and ``--isbeam``.
- ``--noise_variance 0.016 --use_related_text`` (over a bank that
  ``pipeline/related.py`` wrote) and ``--sound_effect`` runs finish with
  finite losses; ``--data_parallel`` in one process trains exactly as the
  run without it (its multi-process runs are in ``test_torch_parallel.py``),
  and a SentencePiece ``.model`` tokenizer trains.

Each run gets its own ``--out_dir``: both drivers name the run dir by the
second.
"""

import json
import math
import os
import pickle
import shutil

import numpy as np
import jax
import pytest
import torch

from zs_aac_tpu.models import caption as jc
from zs_aac_tpu.models.gpt2 import GPT2Config as JGPT2Config
from zs_aac_tpu_torch.models import caption as tc
from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params
from zs_aac_tpu_torch.models.gpt2 import GPT2Config as TGPT2Config
from zs_aac_tpu_torch.utils import checkpoints as tck

torch.set_num_threads(2)

E = 16
CAPTIONS = ["a dog barks in the yard.", "rain falls on the roof.",
            "a car horn blares loudly.", "birds sing in the trees."]
LABELS = ["Dog", "Rain", "Vehicle", "Bird", "Music", "Wind"]
GPT2 = dict(vocab_size=30, n_positions=48, n_embd=32, n_layer=2, n_head=4)


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("sound_effect", [False, True])
@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
def test_save_params_is_read_by_jax_into_its_template(tmp_path, mapping_type, sound_effect):
    from flax import serialization

    from zs_aac_tpu.utils.checkpoints import load_params as j_load_params

    kw = dict(prefix_length=4, prefix_size=E, clip_length=3, num_layers=2,
              mapping_type=mapping_type, sound_effect_num=3 if sound_effect else 0)
    jcfg = jc.CaptionConfig(**kw, gpt2=JGPT2Config(**GPT2))
    port = tc.init_caption_model(tc.CaptionConfig(**kw, gpt2=TGPT2Config(**GPT2)), seed=3,
                                 device="cpu")
    path = str(tmp_path / "best.pth")
    tck.save_params(path, port)
    host = to_jax_params(port)
    # flax's own bytes for the same tree
    assert open(path, "rb").read() == serialization.to_bytes(host)
    shapes = jax.eval_shape(lambda k: jc.init_caption_model(k, jcfg), jax.random.key(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    restored = _flat(j_load_params(path, template))
    want = _flat(host)
    assert sorted(restored) == sorted(want) == sorted(_flat(template))
    for k in want:
        assert restored[k].dtype == want[k].dtype and np.array_equal(restored[k], want[k]), k
        assert restored[k].shape == _flat(template)[k].shape, k
    again = _flat(to_jax_params(from_jax_params(tck.load_params(path), device="cpu")))
    assert sorted(again) == sorted(want)
    assert all(np.array_equal(again[k], want[k]) for k in want)


def test_async_save_snapshots_before_returning(tmp_path):
    port = tc.init_caption_model(tc.CaptionConfig(prefix_size=E, prefix_length=2,
                                                  gpt2=TGPT2Config(**GPT2)), device="cpu")
    want = _flat(to_jax_params(port))
    path = str(tmp_path / "last.pth")
    tck.save_params_async(path, port)
    with torch.no_grad():     # training goes on updating in place
        for p in port["mapper"].parameters():
            p.add_(1.0)
        port["gpt2"]["wte"].add_(1.0)
    tck.join_async_saves()
    got = _flat(tck.load_params(path))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _cluster(r, k, noise=0.05):
    c = np.zeros(E, np.float32)
    c[k * 4:(k + 1) * 4] = 1.0
    return (c + noise * r.standard_normal(E)).astype(np.float32)[None]


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    root = tmp_path_factory.mktemp("caption_banks")
    r = np.random.default_rng(0)
    train = [{"audio_id": f"train{i}", "caption": CAPTIONS[i % 4],
              "text_embedding": _cluster(r, i % 4), "audio_embedding": _cluster(r, i % 4)}
             for i in range(48)]
    test = [{"audio_id": f"clip{i}", "audio_embedding": _cluster(r, i % 4),
             "caption": [{"caption": CAPTIONS[i % 4]}, {"caption": CAPTIONS[(i + 1) % 4]}]}
            for i in range(10)]
    labels = [{"label": name, "label_embedding": _cluster(r, j % 4, 0.3), "label_id": j}
              for j, name in enumerate(LABELS)]
    paths = {k: str(root / f"{k}.pkl") for k in ("train", "test", "labels")}
    for k, recs in (("train", train), ("test", test), ("labels", labels)):
        with open(paths[k], "wb") as f:
            pickle.dump(recs, f)
    return paths


def _driver_args(banks, out_dir, *extra):
    return ["--data", banks["train"], "--valdata", banks["test"], "--out_dir", out_dir,
            "--bs", "8", "--epochs", "2", "--warmup", "1", "--lr", "1e-3",
            "--val_interval", "3", "--max_iters", "6", "--gpt2_size", "tiny",
            "--prefix_dim", str(E), "--prefix_length", "4", "--prefix_length_clip", "4",
            *extra]


def _jax_init(banks, path):
    """The drivers' model, initialized and saved by the JAX package."""
    from zs_aac_tpu.train.train_prompt import _gpt2_config, _make_tokenizer
    from zs_aac_tpu.utils.checkpoints import save_params

    class _A:
        tokenizer = None

    tok, _ = _make_tokenizer(_A(), [banks["train"]])
    cfg = jc.CaptionConfig(prefix_length=4, prefix_size=E, clip_length=4,
                           gpt2=_gpt2_config("tiny", tok.vocab_size))
    save_params(path, jc.init_caption_model(jax.random.key(7), cfg))


def _val_scores(run_dir):
    lines = open(os.path.join(run_dir, "train_caption.log")).read().splitlines()
    rows = [ln.split("\t") for ln in lines[2:]]
    return [(r[0].strip(), r[2].strip()) for r in rows], [float(r[1]) for r in rows]


@pytest.fixture(scope="module")
def both_runs(banks, tmp_path_factory):
    from zs_aac_tpu.train.train_prompt import main as j_train
    from zs_aac_tpu_torch.train.train_prompt import main as t_train

    root = tmp_path_factory.mktemp("runs")
    init = str(root / "init.pth")
    _jax_init(banks, init)
    jrun = j_train(_driver_args(banks, str(root / "jax"), "--ckpt_file", init))
    trun = t_train(_driver_args(banks, str(root / "port"), "--ckpt_file", init,
                                "--device", "cpu"))
    return jrun, trun


def test_drivers_agree_from_one_jax_init(both_runs):
    jrun, trun = both_runs
    for name in ("params.json", "train_caption.log", "last.pth", "best.pth"):
        assert os.path.exists(os.path.join(trun, name)), name
    jparams = json.load(open(os.path.join(jrun, "params.json")))
    tparams = json.load(open(os.path.join(trun, "params.json")))
    assert tparams["gpt2_vocab_size"] == jparams["gpt2_vocab_size"]
    assert sorted(set(jparams) - {"device"}) == sorted(set(tparams) - {"device"})
    for name in ("last.pth", "best.pth"):
        want = _flat(tck.load_params(os.path.join(jrun, name)))
        got = _flat(tck.load_params(os.path.join(trun, name)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=f"{name} {k}")
    (jscores, jlosses), (tscores, tlosses) = _val_scores(jrun), _val_scores(trun)
    assert tscores == jscores and [s[0] for s in tscores] == ["0", "0", "final"]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)


@pytest.mark.parametrize("flags", [[], ["--isbeam"]])
def test_both_predict_drivers_read_the_port_run_dir(both_runs, banks, tmp_path, flags):
    from zs_aac_tpu.train.predict_prompt import main as j_predict
    from zs_aac_tpu_torch.train.predict_prompt import main as t_predict

    _, trun = both_runs
    outs = {}
    for side, predict, extra in (("jax", j_predict, []), ("port", t_predict, ["--device", "cpu"])):
        run = str(tmp_path / side)
        shutil.copytree(trun, run)
        predict(["--test_dir", run, "--data", banks["test"], *flags, *extra])
        with open(os.path.join(run, "output.txt")) as f:
            outs[side] = {p["filename"]: p["caption"] for p in json.load(f)["predictions"]}
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 10


def test_related_text_with_noise_and_sound_effect_runs(banks, tmp_path):
    from zs_aac_tpu_torch.pipeline.related import main as related
    from zs_aac_tpu_torch.train.train_prompt import main as t_train

    rel = str(tmp_path / "related.pkl")
    related(["--input_path", banks["train"], "--output_path", rel, "--topnumber", "3",
             "--device", "cpu"])
    for i, extra in enumerate((["--noise_variance", "0.016", "--use_related_text"],
                               ["--sound_effect", banks["labels"], "--mask_probability",
                                "0.3"])):
        args = _driver_args(banks, str(tmp_path / f"run{i}"), "--device", "cpu", *extra)
        if i == 0:
            args[1] = rel
        run = t_train(args + ["--max_iters", "3"])
        scores, losses = _val_scores(run)
        assert losses and all(math.isfinite(v) for v in losses), losses
        assert os.path.exists(os.path.join(run, "best.pth"))


@pytest.mark.parametrize("extra", [["--data_parallel"], ["--tokenizer", "spm.model"]])
def test_later_slices_raise(banks, tmp_path, extra):
    """Both flags were refused until their slices ported them.
    ``--data_parallel`` (the multi-GPU slice) in one process, with no
    ``torchrun`` environment, runs the one-process step: its ``last.pth``
    is bitwise the run's without the flag. A SentencePiece ``.model``
    tokenizer (the Mistral slice) trains (finite losses, the run's
    vocabulary the model's)."""
    from zs_aac_tpu_torch import testdata
    from zs_aac_tpu_torch.train.train_prompt import main as t_train

    if extra[0] == "--data_parallel":
        runs = [t_train(_driver_args(banks, str(tmp_path / name), "--device", "cpu",
                                     "--max_iters", "3", *flags))
                for name, flags in (("plain", ()), ("dp", extra))]
        plain, dp = (_flat(tck.load_params(os.path.join(r, "last.pth"))) for r in runs)
        assert sorted(plain) == sorted(dp)
        assert all(np.array_equal(plain[k], dp[k]) for k in plain)
        assert json.load(open(os.path.join(runs[1], "params.json")))["data_parallel"]
        return
    spm = str(tmp_path / extra[1])
    tok = testdata.write_word_bpe_model(spm, " ".join(CAPTIONS).split())
    run = t_train(_driver_args(banks, str(tmp_path / "runs"), "--device", "cpu",
                               "--tokenizer", spm, "--max_iters", "3"))
    _, losses = _val_scores(run)
    assert losses and all(math.isfinite(v) for v in losses), losses
    params = json.load(open(os.path.join(run, "params.json")))
    assert params["tokenizer"] == spm and params["gpt2_vocab_size"] == tok.vocab_size
