"""Fault C5: the port reads its configs and CSV corpora without pyyaml or
pandas, which the card machine lacks.

- ``utils.config.load_config`` equals ``yaml.safe_load`` on every file in
  ``configs/``, on the JAX end-to-end toy's ``yaml.safe_dump`` output of its
  config, and on a list of YAML 1.1 cases where PyYAML's answer is not the
  one a reader expects; outside its subset it raises a ``ValueError`` that
  names the line.
- ``extract --corpus musiccaps`` and ``--corpus audioset`` give the JAX
  package's records on CSVs with quoted commas and quotes, empty cells and a
  blank line.
- ``pretrain.main``, ``finetune.main`` and ``extract.main`` (a bank and
  ``--corpus audioset``) run in a fresh interpreter in which importing
  ``yaml`` or ``pandas`` fails.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from zs_aac_tpu_torch.utils.config import load_config, parse_yaml

REPO = Path(__file__).resolve().parents[1]


def same(a, b):
    """Equal values of equal types (nan equal to nan), key order included."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_repo_configs_read_as_pyyaml_reads_them(path):
    p = REPO / "configs" / path
    assert same(load_config(str(p)), yaml.safe_load(p.read_text()))


def jax_toy_config(root="/data/toy run"):
    """The JAX toy's config (``examples/end_to_end_toy.py:107-136``) with the
    pretrain path it adds after stage 2."""
    return {
        "exp_name": "toy", "seed": 20, "embed_size": 16, "temp": 0.07,
        "embed_regularization": False, "json_files": [f"{root}/pretrain.json"],
        "blacklist": None, "resume": False, "val_datasets": [],
        "data_root": root, "output_dir": f"{root}/outputs",
        "audio_channels": [4, 8],
        "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320,
                       "f_min": 50, "f_max": 14000, "n_mels": 64,
                       "max_length": 2, "mono": True},
        "audio_encoder_args": {"type": "cnn", "model": "Cnn14",
                               "pretrained": False, "freeze": False},
        "data_args": {"batch_size": 8, "num_workers": 0},
        "text_encoder_args": {"type": "prajjwal1/bert-tiny",
                              "vocab": f"{root}/bert_vocab.txt"},
        "optim_args": {"lr": 2e-3, "scheduler": "cosine",
                       "optimizer_name": "adam", "betas": [0.9, 0.999],
                       "eps": 1e-8, "momentum": 0.9, "warmup_epochs": 0,
                       "weight_decay": 0.0},
        "training": {"spec_augmentation": False, "epochs": 100, "clip_grad": 2,
                     "dropout": 0.2},
        "pretrain_path": f"{root}/outputs/toy_Cnn14_lr_0.002_seed_20/models/best_model.ckpt",
    }


@pytest.mark.parametrize("flow", [False, None, True], ids=["block", "default", "flow"])
def test_safe_dump_output_reads_back(flow, tmp_path):
    cfg = jax_toy_config()
    text = yaml.safe_dump(cfg, default_flow_style=flow)
    assert same(parse_yaml(text), yaml.safe_load(text)) and yaml.safe_load(text) == cfg
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    assert same(load_config(str(tmp_path / "c.json")), cfg)


YAML11 = [
    "k: 5e-5", "k: 1e3", "k: 1.0e3", "k: 1.0e+3", "k: 1.e-3", "k: -.5e-3", "k: .5", "k: +.5",
    "k: 0.", "k: !!float 5e-5", "k: !!float '1e3'", "k: !!int '7'", "k: !!str 12",
    "k: !!bool yes", "k: !!null ''", "k: 1_000", "k: 017", "k: 09", "k: 0x1F", "k: 0b101",
    "k: 0o17", "k: 1:30", "k: -1:30", "k: 1.5:30", "k: 1:30.5", "k: .inf", "k: -.Inf",
    "k: .NaN", "k: yes", "k: No", "k: ON", "k: off", "k: y", "k: n", "k: True",
    "k: TRUE", "k: tRue", "k: ~", "k:", "k: null", "k: Null", "k: nUll", "k: 12e", "k: 1,000",
    "k: 'it''s # not a comment'", 'k: "tab\\there \\u00e9 \\x41 \\"q\\""', "k: a#b",
    "k: a #b", "k: http://x.y/z?a=1", "k: '  padded '", "k: ''", "k: [a, 'b', 1, 2.5, [c], {e: 1}]",
    "k: {a: 1, b: [x, y], c: }", "k: [\n  1,\n  2,  # two\n]\nj: 3", "a:\n- 1\n- - 2\n  - 3\nb: x",
    "a:\n  - x: 1\n    y: [2]\n  -\n    z: 3\nb:\n  c:\n    d: 4", "- a\n- b: 1\n  c: 2",
    "1: one\n2.5: two\ntrue: t\nnull: n", "'quoted key': 1\n\"k2\": 2", "---\nk: 1",
    "k: v  # trailing\n# full line\n\nl: w",
]


@pytest.mark.parametrize("text", YAML11)
def test_yaml_1_1_cases_read_as_pyyaml_reads_them(text):
    assert same(parse_yaml(text), yaml.safe_load(text)), (parse_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &anchor 2", 2), ("a: 1\nb: *alias", 2), ("a: |\n  block", 1),
    ("a: >\n  folded", 1), ("a: 1\n---\nb: 2", 2), ("a: 2001-12-14", 1),
    ("a: plain\n  continued", 2), ("a: 'open\n  quote'", 1), ("a: [1, 2", 1),
    ("a: 1\n  b: 2", 2), ("? complex\n: key", 1), ("a: b: c", 1), ("a: !!set {x}", 1),
])
def test_outside_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}"):
        parse_yaml(text)


# --- the CSV corpora ---------------------------------------------------------------


@pytest.mark.parametrize("corpus", ["musiccaps", "audioset"])
def test_csv_corpora_match_jax(tmp_path, corpus):
    from zs_aac_tpu.pipeline.extract import _corpus_texts as jax_texts
    from zs_aac_tpu_torch.pipeline.extract import _corpus_texts

    path = tmp_path / "c.csv"
    if corpus == "musiccaps":
        path.write_text(
            'ytid,caption,aspect_list\n'
            'a1,"A calm piano tune, played slowly. It has a warm tone and soft echo.","[x, y]"\n'
            'a2,,"[]"\n'
            '\n'
            'a3,"The ""lead"" guitar plays a riff over drums. Short.",z\n'
            'a4,"Ünïcode words for the test here. and, more words, to pass",q\n',
            encoding="utf-8")
    else:
        path.write_text('index,mid,display_name\n0,/m/0,Dog\n1,/m/1,"Speech, synthesized"\n'
                        '\n2,/m/2,"The ""quoted"" one"\n', encoding="utf-8")
    want, got = jax_texts(corpus, str(path)), _corpus_texts(corpus, str(path))
    assert got == want and len(want) >= 3


# --- pretrain, finetune and extract with yaml and pandas blocked --------------------


BLOCKED = r"""
import sys
sys.modules["yaml"] = None
sys.modules["pandas"] = None
import json, os
os.environ["WANDB_MODE"] = "disabled"
from zs_aac_tpu_torch.train import finetune, pretrain
from zs_aac_tpu_torch.pipeline import extract
root = sys.argv[1]
ckpt_dir = pretrain.main(["-c", root + "/config.yaml", "--max_steps", "1",
                          "--max_val_batches", "1", "--device", "cpu"])
best = os.path.join(ckpt_dir, "best_model.ckpt")
finetune.main(["-c", root + "/config.yaml", "-d", "Toy", "--max_steps", "1",
               "--max_val_batches", "1", "--pretrain_path", best, "--device", "cpu"])
extract.main(["--config", root + "/config.yaml", "--ckpt", best, "--dataset_path",
              root + "/bank", "--out_path", root + "/banks", "--splits", "train",
              "--batch", "4", "--device", "cpu"])
extract.main(["--config", root + "/config.yaml", "--ckpt", best, "--corpus", "audioset",
              "--text_input", root + "/labels.csv", "--out_path", root + "/labels.pkl",
              "--device", "cpu"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
                        & {"yaml", "pandas", "jax", "zs_aac_tpu"})))
"""


def test_drivers_run_with_yaml_and_pandas_blocked(tmp_path):
    from test_retrieval_pipeline import _mk_corpus
    from test_torch_extract import absolute_manifest, make_dataset
    from test_torch_pretrain import _config

    root = str(tmp_path)
    config = _config(root, _mk_corpus(root, n_audio=4))
    config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14"}
    config["audio_channels"] = [4, 8]
    config["optim_args"]["lr"] = 5e-5          # a float yaml writes as 5.0e-05
    del config["htsat_kwargs"]
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    make_dataset(str(tmp_path / "bank" / "train"), n=2)
    absolute_manifest(str(tmp_path / "bank" / "train"))
    (tmp_path / "labels.csv").write_text('index,mid,display_name\n0,/m/0,dog\n1,/m/1,"rain, wind"\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCKED, root], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    import pickle

    with open(tmp_path / "labels.pkl", "rb") as f:
        labels = pickle.load(f)
    assert [r["label"] for r in labels] == ["dog", "rain, wind"]
    with open(tmp_path / "banks" / "train" / "clap_embedding" / "ZS" / "data.pkl", "rb") as f:
        bank = pickle.load(f)
    assert len(bank) == 4 and np.isfinite(bank[0]["audio_embedding"]).all()
