"""The port's bank extraction against the JAX package's, and the committed
tiny-ASE fixture.

Synthetic WAVs (16-bit at 44.1 kHz, which take the int16 PCM + on-device
resample path, and a 24-bit clip at 48 kHz, which takes the host decode +
resample path) go through both packages' ``extract_audio_text_bank`` with
encoders on the same reference-layout weights (``test_torch_bert_ase``'s
tiny CLAP checkpoint). The port's encoders come from its
``load_ase_encoders`` (``--device cpu``: the kernels' plain versions); the
JAX package's are built as its ``load_ase_encoders`` builds them, from the
same checkpoint. Records must match: ids and captions equal, embeddings
within 5e-5 (fp32, L2-normalized, summation order only).

The committed fixture ``zs_aac_tpu_torch/testdata/tiny_ase`` (regenerate with
``PYTHONPATH=. python tests/test_torch_extract.py --write-fixture``) holds
the checkpoint, a small vocab, four WAVs and the embeddings the JAX
package's ``extract_audio_text_bank`` gave for them.
"""

import csv
import json
import os
import pickle
import shutil
import sys
import wave as wavemod

import numpy as np
import pytest
import torch

from test_torch_bert_ase import (ase_config_kwargs, reference_state_dict,
                                 register_tiny_bert_in_jax)
from zs_aac_tpu_torch.pipeline import extract as port_extract
from zs_aac_tpu_torch.testdata import TINY_ASE_DIR, stage_tiny_ase

torch.set_num_threads(2)

CAPTIONS = ["A dog barks in the yard.", "Rain falls on the roof!",
            "A car horn blares, loudly.", "Birds sing in the trees."]
WORDS = sorted({w for c in CAPTIONS for w in c.lower().replace(".", " ").replace(
    "!", " ").replace(",", " ").split()})
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
         + ["##s", "##ing", "sound", "noise", "."])
VOCAB += [f"[unused{i}]" for i in range(64 - len(VOCAB))]
AUDIO_ARGS = {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50, "f_max": 14000,
              "n_mels": 16, "max_length": 1, "mono": True}
TOL = 5e-5


def make_config(vocab_path):
    kw = ase_config_kwargs()
    return {"audio_args": dict(AUDIO_ARGS),
            "audio_encoder_args": {"type": "transformer", "model": "HTSAT"},
            "text_encoder_args": {"type": kw["text_model"], "vocab": vocab_path},
            "htsat_kwargs": {k: list(v) if isinstance(v, tuple) else v
                             for k, v in kw["htsat_kwargs"]},
            "embed_size": kw["embed_size"], "training": {"spec_augmentation": False},
            "compute_dtype": "float32"}


def _write_wav(path, x, sr, width=2):
    with wavemod.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(sr)
        if width == 2:
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        else:  # 24-bit little-endian
            v = (np.clip(x, -1, 1) * 8388607).astype(np.int32)
            b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8)
            w.writeframes(b.tobytes())


def make_dataset(root, n=4, seed=0, with_24bit=False):
    """``n`` clips (0.3-1.2 s: some padded, one truncated) + wav.csv + text.json."""
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, audios = [], []
    for i in range(n):
        sr, width = (48000, 3) if with_24bit and i == n - 1 else (44100, 2)
        dur = (0.5, 0.7, 1.2, 0.3)[i % 4]
        t = np.arange(int(dur * sr)) / sr
        x = 0.3 * np.sin(2 * np.pi * (300 + 250 * i) * t) + 0.05 * rng.standard_normal(t.size)
        name = f"audio/clip{i}.wav"
        _write_wav(os.path.join(root, name), x, sr, width)
        rows.append({"audio_id": f"clip{i}", "file_name": name})
        audios.append({"audio_id": f"clip{i}",
                       "captions": [{"caption": CAPTIONS[i % 4], "cap_id": "1"},
                                    {"caption": CAPTIONS[(i + 1) % 4], "cap_id": "2"}]})
    with open(os.path.join(root, "wav.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["audio_id", "file_name"], delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(root, "text.json"), "w") as f:
        json.dump({"audios": audios}, f)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")


def absolute_manifest(root):
    """Point wav.csv's file names at ``root`` (they are stored relative)."""
    path = os.path.join(root, "wav.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["audio_id", "file_name"], delimiter="\t")
        w.writeheader()
        for r in rows:
            w.writerow({"audio_id": r["audio_id"],
                        "file_name": os.path.join(root, r["file_name"])})


def jax_encoders(state_dict, config):
    """The JAX package's encoders as its ``load_ase_encoders`` builds them,
    with the variables converted from a reference-layout checkpoint."""
    import jax
    import jax.numpy as jnp

    from zs_aac_tpu.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu.data.text_transform import text_preprocess
    from zs_aac_tpu.models.ase import ASE, ASEConfig
    from zs_aac_tpu.models.convert import convert_ase
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.ops.resample import resample_poly_device
    from zs_aac_tpu.train.contrastive import make_encode_fns

    cfg = ASEConfig(**ase_config_kwargs())
    variables = jax.tree.map(jnp.asarray, convert_ase(state_dict, cfg))
    mel_cfg = LogMelConfig.from_dict(config["audio_args"])
    enc_a, enc_t = make_encode_fns(ASE(cfg), mel_cfg, mel_impl="xla")
    tokenizer = WordPieceTokenizer.from_file(config["text_encoder_args"]["vocab"])

    def encode_audio(waves):
        return np.asarray(enc_a(variables, jnp.asarray(waves))).astype(np.float32)

    def encode_audio_pcm(pcm, sr_in, target_len):
        waves = resample_poly_device(jnp.asarray(pcm), sr_in, mel_cfg.sr, target_len)
        return np.asarray(enc_a(variables, waves)).astype(np.float32)

    encode_audio.pcm = encode_audio_pcm

    def encode_text(texts):
        ids, mask = tokenizer.batch_encode([text_preprocess(t) for t in texts],
                                           max_length=30, pad_to_max=True)
        return np.asarray(enc_t(variables, jnp.asarray(ids), jnp.asarray(mask))).astype(
            np.float32)

    return encode_audio, encode_text


def jax_bank(state_dict, config, data_path, with_text, batch_size):
    from zs_aac_tpu.models import ase as jase
    from zs_aac_tpu.pipeline.extract import extract_audio_text_bank

    saved = dict(jase.TEXT_MODEL_REGISTRY)
    register_tiny_bert_in_jax(dict.__setitem__)
    try:
        ea, et = jax_encoders(state_dict, config)
        return extract_audio_text_bank(ea, et, data_path, with_text, config["audio_args"],
                                       batch_size)
    finally:
        jase.TEXT_MODEL_REGISTRY.clear()
        jase.TEXT_MODEL_REGISTRY.update(saved)


def assert_banks_match(got, want, tol=TOL):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["audio_id"] == w["audio_id"] and g["caption"] == w["caption"]
        np.testing.assert_allclose(np.asarray(g["audio_embedding"]),
                                   np.asarray(w["audio_embedding"]), rtol=0, atol=tol)
        if isinstance(w["text_embedding"], int):
            assert g["text_embedding"] == w["text_embedding"]
        else:
            np.testing.assert_allclose(np.asarray(g["text_embedding"]),
                                       np.asarray(w["text_embedding"]), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bank"))
    make_dataset(root, n=5, with_24bit=True)
    absolute_manifest(root)
    sd = reference_state_dict(seed=2)
    ckpt = os.path.join(root, "ase.pt")
    torch.save(sd, ckpt)
    return {"root": root, "sd": sd, "ckpt": ckpt,
            "config": make_config(os.path.join(root, "vocab.txt"))}


@pytest.mark.parametrize("with_text", [True, False], ids=["train", "test"])
def test_bank_matches_jax(dataset, with_text):
    config = dataset["config"]
    want = jax_bank(dataset["sd"], config, dataset["root"], with_text, 3)
    ea, et = port_extract.load_ase_encoders(config, dataset["ckpt"], device="cpu")
    got = port_extract.extract_audio_text_bank(ea, et, dataset["root"], with_text,
                                               config["audio_args"], batch_size=3)
    assert len(got) == (10 if with_text else 5)
    assert_banks_match(got, want)


def test_main_writes_the_banks(dataset, tmp_path):
    yaml = pytest.importorskip("yaml")
    data = tmp_path / "data"
    for split in ("train", "test"):
        shutil.copytree(dataset["root"], data / split)
    config = dict(dataset["config"], pretrain_path=dataset["ckpt"])
    cfg_path = tmp_path / "extract.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    out = tmp_path / "out"
    port_extract.main(["--config", str(cfg_path), "--dataset_path", str(data), "--out_path",
                       str(out), "--splits", "train", "test", "--batch", "4",
                       "--device", "cpu"])
    for split, n in (("train", 10), ("test", 5)):
        with open(out / split / "clap_embedding" / "ZS" / "data.pkl", "rb") as f:
            recs = pickle.load(f)
        assert len(recs) == n and recs[0]["audio_embedding"].shape == (1, 32)


@pytest.mark.parametrize("corpus", ["wavcaps_json", "msd", "coco", "chatgpt", "audioset"])
def test_text_banks_match_jax(tmp_path, corpus):
    from zs_aac_tpu.pipeline.extract import extract_text_bank as jax_text_bank

    def encode_text(texts):
        return np.stack([np.full(4, len(t), np.float32) + np.arange(4) for t in texts])

    caps = ["a dog barks at the mailman today", "rain", "cars pass by on the wet road ok"]
    if corpus == "wavcaps_json":
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"num_captions_per_audio": 1,
                                    "data": [{"caption": c} for c in caps]}))
    elif corpus == "msd":
        path = tmp_path / "c.pkl"
        path.write_bytes(pickle.dumps([{"caption": ". ".join(caps)}]))
    elif corpus == "coco":
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"annotations": [{"caption": c} for c in caps]}))
    elif corpus == "chatgpt":
        path = tmp_path / "c.txt"
        path.write_text("\n".join(caps + ["x", ""]) + "\n")
    else:
        path = tmp_path / "labels.csv"
        path.write_text("index,mid,display_name\n0,/m/0,Dog\n1,/m/1,Rain\n")
    want = jax_text_bank(encode_text, corpus, str(path), batch_size=2)
    got = port_extract.extract_text_bank(encode_text, corpus, str(path), batch_size=2)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


def test_orbax_checkpoint_dirs_wait(dataset, tmp_path):
    with pytest.raises(NotImplementedError, match="later slice"):
        port_extract.load_ase_encoders(dataset["config"], str(tmp_path), device="cpu")


def test_committed_fixture_embeddings(tmp_path):
    """The port (plain versions, CPU) reproduces the embeddings the JAX
    package recorded for the committed fixture."""
    staged = stage_tiny_ase(tmp_path)
    ea, et = port_extract.load_ase_encoders(staged["config"], staged["ckpt"], device="cpu")
    got = port_extract.extract_audio_text_bank(ea, et, staged["data_path"], True,
                                               staged["config"]["audio_args"], batch_size=4)
    assert_banks_match(got, staged["expected"])
    size = sum(p.stat().st_size for p in TINY_ASE_DIR.rglob("*") if p.is_file())
    assert size < 1_000_000


def test_chip_smoke_config_is_the_extract_yaml():
    """``chip_smoke.py`` (run where no yaml reader is installed) keeps a copy
    of ``configs/extract_data.yaml``'s encoder settings."""
    import importlib.util
    from pathlib import Path

    yaml = pytest.importorskip("yaml")
    repo = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke", repo / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(repo / "configs" / "extract_data.yaml") as f:
        config = yaml.safe_load(f)
    for key, value in smoke.EXTRACT_CONFIG.items():
        if isinstance(value, dict):
            assert {k: config[key][k] for k in value} == value, key
        else:
            assert config[key] == value, key


def write_fixture():
    """Regenerate ``zs_aac_tpu_torch/testdata/tiny_ase``."""
    out = str(TINY_ASE_DIR)
    if os.path.isdir(out):
        shutil.rmtree(out)
    make_dataset(out, n=4)
    sd = reference_state_dict(seed=3)
    torch.save({k: v for k, v in sd.items()
                if not k.endswith(("relative_position_index", "attn_mask",
                                   "num_batches_tracked"))},
               os.path.join(out, "ase.pt"))
    config = make_config("vocab.txt")
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(config, f, indent=1, sort_keys=True)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        shutil.copytree(out, data)
        absolute_manifest(data)
        config["text_encoder_args"]["vocab"] = os.path.join(data, "vocab.txt")
        recs = jax_bank(sd, config, data, True, 4)
    expected = [{"audio_id": r["audio_id"], "caption": r["caption"],
                 "audio_embedding": np.asarray(r["audio_embedding"]).tolist(),
                 "text_embedding": np.asarray(r["text_embedding"]).tolist()} for r in recs]
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f)
    print(f"wrote {out}: {sorted(os.listdir(out))}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        os.environ["JAX_PLATFORMS"] = "cpu"
        write_fixture()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_extract.py --write-fixture")
