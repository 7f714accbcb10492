"""The port's zero-shot classification (``eval/zero_shot.py``) against the JAX
package's: ``classify`` on the same tiny ASE and waves, and ``main`` on
synthetic UrbanSound8K and ESC-50 trees (the real CSV columns; WAVs at 44.1
and 32 kHz, so resampling runs) with the same weights, the JAX package's as
an orbax train state and the port's as its own train state.

The JAX driver builds its model with ``build_ase_from_config``, which takes no
HTSAT geometry: the UrbanSound8K case replaces its ``HTSAT`` with a subclass
at the tiny geometry of ``tests/test_torch_pretrain.py`` inside the test
process (the port reads the same geometry from the config's
``htsat_kwargs``). Predictions and accuracies are compared for equality.
"""

import csv
import importlib.util
import json
import os
import wave as wavemod

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from test_torch_bert_ase import register_tiny_bert_in_jax, tiny_registry  # noqa: F401
from test_torch_pretrain import HTSAT_KW
from zs_aac_tpu.eval import zero_shot as jzs
from zs_aac_tpu.models import htsat as jhtsat
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.eval import zero_shot as tzs
from zs_aac_tpu_torch.models.convert import from_jax_params
from zs_aac_tpu_torch.utils.checkpoints import load_params

torch.set_num_threads(2)

ESC_CLASSES = ["dog", "rain", "sea_waves", "crying_baby"]
US8K_CLASSES = ["air_conditioner", "car_horn", "children_playing", "dog_bark"]


def _write_wav(path, x, sr):
    with wavemod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def _clip(rng, label, seconds, sr):
    """Seeded noise under a tone whose pitch follows the label."""
    t = np.arange(int(seconds * sr)) / sr
    return 0.3 * np.sin(2 * np.pi * (200.0 * (label + 1)) * t) + 0.05 * rng.standard_normal(t.size)


def make_esc50(root, per_fold=2):
    """``ESC-50/meta/esc50.csv`` + ``ESC-50/audio/``: 5 folds, 5 s clips at
    44.1 kHz, the real table's columns."""
    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/ESC-50/meta")
    os.makedirs(f"{root}/ESC-50/audio")
    rows = []
    for fold in range(1, 6):
        for i in range(per_fold):
            target = int(rng.integers(0, len(ESC_CLASSES)))
            name = f"{fold}-{1000 + i}-A-{target}.wav"
            _write_wav(f"{root}/ESC-50/audio/{name}", _clip(rng, target, 5, 44100), 44100)
            rows.append({"filename": name, "fold": fold, "target": target,
                         "category": ESC_CLASSES[target], "esc10": "False",
                         "src_file": 1000 + i, "take": "A"})
    with open(f"{root}/ESC-50/meta/esc50.csv", "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def make_urbansound8k(root):
    """``UrbanSound8K/metadata/UrbanSound8K.csv`` + ``audio/fold<k>/``: 10
    folds, 1-4 s clips at 44.1 or 32 kHz, the real table's columns."""
    rng = np.random.default_rng(1)
    os.makedirs(f"{root}/UrbanSound8K/metadata")
    rows = []
    for fold in range(1, 11):
        os.makedirs(f"{root}/UrbanSound8K/audio/fold{fold}")
        for i in range(1 + fold % 2):
            cid = int(rng.integers(0, len(US8K_CLASSES)))
            sr = 44100 if (fold + i) % 2 else 32000
            name = f"{100 * fold + i}-{cid}-0-0.wav"
            _write_wav(f"{root}/UrbanSound8K/audio/fold{fold}/{name}",
                       _clip(rng, cid, float(rng.uniform(1, 4)), sr), sr)
            rows.append({"slice_file_name": name, "fsID": 100 * fold + i, "start": 0.0,
                         "end": 1.0, "salience": 1, "fold": fold, "classID": cid,
                         "class": US8K_CLASSES[cid]})
    with open(f"{root}/UrbanSound8K/metadata/UrbanSound8K.csv", "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _config(tower, vocab):
    n_mels = 64 if tower == "cnn14" else HTSAT_KW["n_mels"]
    config = {
        "embed_size": 32, "temp": 0.07,
        "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50,
                       "f_max": 14000, "n_mels": n_mels, "max_length": 10, "mono": True},
        "text_encoder_args": {"type": "bert-tiny-test", "vocab": vocab},
        "training": {"spec_augmentation": False},
    }
    if tower == "cnn14":
        config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14"}
        config["audio_channels"] = [4, 8]
    else:
        config["audio_encoder_args"] = {"type": "transformer", "model": "HTSAT"}
        config["htsat_kwargs"] = dict(HTSAT_KW)
    return config


def _tiny_jax_htsat(monkeypatch):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in HTSAT_KW.items()}
    monkeypatch.setattr(jhtsat, "HTSAT", type("TinyHTSAT", (jhtsat.HTSAT,), {
        "__annotations__": {k: type(v) for k, v in kw.items()}, **kw}))


def _converter():
    """``examples/convert_jax_state.py``, loaded from its file."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "convert_jax_state.py")
    spec = importlib.util.spec_from_file_location("convert_jax_state", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoints(tmp_path, config):
    """The same random weights as the JAX driver's orbax train state and as
    the port's train state made from it by ``examples/convert_jax_state.py``
    (the state's optimizer is ``finetune``'s): (jax path, port path)."""
    conv = _converter()
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train.contrastive import create_ase_state
    from zs_aac_tpu.train.optim import cosine_lr, get_optimizer
    from zs_aac_tpu.train.pretrain import build_ase_from_config
    from zs_aac_tpu.utils.checkpoints import save_train_state as jax_save

    ase, _ = build_ase_from_config(config)
    mel = LogMelConfig.from_dict(config["audio_args"])
    state = create_ase_state(jax.random.key(7), ase, get_optimizer(cosine_lr(1e-4, 1, 10)),
                             spec_shape=(2, 101, mel.n_mels), text_len=30)
    jpath = str(tmp_path / "jax_state")
    jax_save(jpath, state)
    train_config = tmp_path / "train_config.json"
    train_config.write_text(json.dumps({**config, "optim_args": {"lr": 1e-4}, "training": {
        **config["training"], "epochs": 10, "warmup_epochs": 1}}))
    tpath = str(tmp_path / "best_model.ckpt")
    conv.main(["-c", str(train_config), "--orbax_dir", jpath, "--out", tpath,
             "--driver", "finetune"])
    return jpath, tpath


@pytest.mark.parametrize("dataset,tower", [("esc50", "cnn14"), ("urbansound8k", "htsat")])
def test_main_matches_jax(dataset, tower, tmp_path, monkeypatch, capsys, tiny_registry):
    monkeypatch.setenv("ZS_AAC_NO_COMPILE_CACHE", "1")
    (make_esc50 if dataset == "esc50" else make_urbansound8k)(str(tmp_path))
    if tower == "htsat":
        _tiny_jax_htsat(monkeypatch)
    config = _config(tower, str(testdata.TINY_ASE_DIR / "vocab.txt"))
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    jpath, tpath = _checkpoints(tmp_path, config)
    capsys.readouterr()
    args = ["-c", str(cfg_path), "--dataset", dataset, "--data_root", str(tmp_path),
            "--batch", "4"]
    want = jzs.main(args + ["--ckpt", jpath])
    want_lines = capsys.readouterr().out.strip().splitlines()
    got = tzs.main(args + ["--ckpt", tpath, "--device", "cpu"])
    got_lines = capsys.readouterr().out.strip().splitlines()
    assert got == want
    n_folds = 5 if dataset == "esc50" else 10
    assert got_lines == want_lines and len(got_lines) == n_folds + 1
    assert got_lines[0].startswith("Fold 1 Accuracy ")
    assert got_lines[-1].startswith(f"{dataset} Accuracy ")


def test_classify_matches_jax(tiny_registry):
    """``classify`` on the tiny CLAP checkpoint (Cnn14 tower), the classes'
    embeddings a prototype clip's each: the same predictions as the JAX
    package's encoders give, and the same accuracy."""
    from zs_aac_tpu.models import ase as jase
    from zs_aac_tpu.ops.logmel import LogMelConfig as JaxMel
    from zs_aac_tpu.train.contrastive import make_encode_fns as jax_encode_fns
    from zs_aac_tpu_torch.models import ase as tase
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import make_encode_fns

    meta = json.loads((testdata.TINY_CLAP_DIR / "ase.msgpack.json").read_text())
    acfg = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["ase_config"].items()}
    tree = load_params(str(testdata.TINY_CLAP_DIR / "ase.msgpack"))
    rng = np.random.default_rng(3)
    waves = np.stack([_clip(rng, k % 5, 1.5, 32000) for k in range(10)]).astype(np.float32)
    labels = rng.integers(0, 6, 10)
    batches = lambda: ((waves[s:s + 4], labels[s:s + 4]) for s in range(0, 10, 4))

    ja, _ = jax_encode_fns(jase.ASE(jase.ASEConfig(**acfg)), JaxMel())
    jvars = jax.tree.map(jnp.asarray, tree)
    # class prototypes: the JAX embeddings of one more clip of each label's tone
    protos = np.stack([_clip(rng, k, 1.5, 32000) for k in range(6)]).astype(np.float32)
    text = np.asarray(ja(jvars, jnp.asarray(protos)))
    want_acc = jzs.classify(lambda w: ja(jvars, w), text, batches())
    want_pred = np.concatenate([(np.asarray(ja(jvars, jnp.asarray(w))) @ text.T).argmax(1)
                                for w, _ in batches()])

    ta, _ = make_encode_fns(tase.ASE(tase.ASEConfig(**acfg)), LogMelConfig(), device="cpu")
    tvars = from_jax_params(tree, device="cpu")
    pred = []
    got_acc = tzs.classify(lambda w: ta(tvars, torch.from_numpy(w)).numpy(), text, batches(), pred)
    assert pred == want_pred.tolist()
    assert got_acc == want_acc
    assert len(set(pred)) > 1


@pytest.mark.parametrize("dataset", ["esc50", "urbansound8k"])
def test_tables_list_classes_in_id_order(dataset, tmp_path):
    (make_esc50 if dataset == "esc50" else make_urbansound8k)(str(tmp_path))
    table, _, id_col, _, n_folds, prompt, _ = tzs.DATASETS[dataset]
    with open(tmp_path / table) as f:
        ids = sorted({int(r[id_col]) for r in csv.DictReader(f)})
    names = ESC_CLASSES if dataset == "esc50" else US8K_CLASSES
    classes, folds = tzs._table(str(tmp_path), dataset)
    assert classes == [prompt.format(names[i].replace("_", " ")) for i in ids]
    assert sorted(folds) == list(range(1, n_folds + 1))
    for paths, labels in folds.values():
        assert labels == sorted(labels) and all(os.path.exists(p) for p in paths)


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    args = tzs.build_parser().parse_args(["-c", "x", "--ckpt", "y"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tzs.main(["-c", str(tmp_path / "none.yaml"), "--ckpt", "none.ckpt"])


def test_chip_smoke_inference_config_matches_the_yaml():
    """``chip_smoke.py`` cannot read yaml on the card; its copy of
    ``configs/inference.yaml``'s encoder settings must stay the file's."""
    import importlib.util
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(repo / "configs" / "inference.yaml") as f:
        config = yaml.safe_load(f)
    for key, value in smoke.INFERENCE_CONFIG.items():
        if isinstance(value, dict):
            assert {k: config[key][k] for k in value} == value, key
        else:
            assert config[key] == value, key
