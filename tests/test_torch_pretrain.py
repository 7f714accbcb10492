"""The port's retrieval training drivers and their host pieces.

- ``pretrain`` and ``finetune`` run end to end with ``--device cpu`` on a
  synthetic corpus (built as ``tests/test_retrieval_pipeline.py`` builds
  it) with a tiny HTSAT + BERT: checkpoints are written, the log holds the
  t2a/a2t recalls and the test-set evaluation of every saved checkpoint,
  a resume restores the step, and the finetune warm start loads the
  pretrained parameters.
- The data path gives the JAX package's batches for the same seed
  (``BySequenceLengthSampler``, ``pretrain_batches``,
  ``AudioCaptionDataModule``), and ``t2a``/``a2t`` equal JAX's on random
  embeddings.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from test_retrieval_pipeline import _mk_corpus, glob_one
from zs_aac_tpu.data import retrieval_data as jdata
from zs_aac_tpu.data import sampler as jsampler
from zs_aac_tpu.data.bert_tokenizer import WordPieceTokenizer as JaxTokenizer
from zs_aac_tpu.eval import retrieval as jretrieval
from zs_aac_tpu_torch.data import retrieval_data as tdata
from zs_aac_tpu_torch.data import sampler as tsampler
from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer
from zs_aac_tpu_torch.eval import retrieval as tretrieval
from zs_aac_tpu_torch.train import finetune, pretrain
from zs_aac_tpu_torch.utils.checkpoints import restore_model_only

torch.set_num_threads(2)

# a tiny HTSAT whose input holds a 10 s bucket (1001 frames <= 128 * 8)
HTSAT_KW = {"spec_size": 128, "patch_size": 4, "patch_stride": 4, "embed_dim": 16,
            "depths": [2, 2], "num_heads": [2, 4], "window_size": 4, "n_mels": 16,
            "drop_path_rate": 0.1}


def _config(root, vocab):
    return {
        "exp_name": "smoke", "seed": 20, "embed_size": 16, "temp": 0.07,
        "embed_regularization": True, "json_files": [f"{root}/pretrain.json"],
        "blacklist": None, "resume": False, "val_datasets": ["Toy"], "data_root": root,
        "output_dir": f"{root}/outputs",
        "audio_args": {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50,
                       "f_max": 14000, "n_mels": 16, "max_length": 5, "mono": True},
        "audio_encoder_args": {"type": "transformer", "model": "HTSAT", "pretrained": False,
                               "freeze": False},
        "htsat_kwargs": dict(HTSAT_KW),
        "data_args": {"batch_size": 4, "num_workers": 0},
        "text_encoder_args": {"type": "bert-tiny-test", "vocab": vocab, "freeze": False},
        "optim_args": {"lr": 5e-4, "scheduler": "cosine", "optimizer_name": "adam",
                       "betas": [0.9, 0.999], "eps": 1e-8, "momentum": 0.9,
                       "warmup_epochs": 0, "weight_decay": 0.0},
        "training": {"spec_augmentation": True, "epochs": 1, "clip_grad": 2, "dropout": 0.2},
    }


def _write(config, path):
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def test_pretrain_resume_and_finetune_drivers(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "disabled")   # the driver logs wherever wandb imports
    root = str(tmp_path)
    vocab = _mk_corpus(root, n_audio=8)
    config = _config(root, vocab)
    cfg_path = _write(config, f"{root}/config.yaml")
    ckpt_dir = pretrain.main(["-c", cfg_path, "--max_steps", "2", "--max_val_batches", "2",
                              "--device", "cpu"])
    best = os.path.join(ckpt_dir, "best_model.ckpt")
    assert os.path.exists(best) and os.path.exists(os.path.join(ckpt_dir, "Toy_best_model.ckpt"))
    log = open(glob_one(f"{root}/outputs", "output.log")).read()
    assert "Toy t2a: r1:" in log and "Toy a2t: r1:" in log
    assert "Toy-test[best_model] t2a" in log and "Toy-test[Toy_best_model] a2t" in log
    saved = torch.load(best, map_location="cpu", weights_only=True)
    assert saved["step"] == 2

    # resume: the step comes back from the checkpoint, and training goes on
    resumed = _write({**config, "resume": True, "seed": 20}, f"{root}/resume.yaml")
    pretrain.main(["-c", resumed, "--resume_ckpt", best, "--max_steps", "1",
                   "--max_val_batches", "1", "--device", "cpu", "--epochs", "2"])
    assert torch.load(best, map_location="cpu", weights_only=True)["step"] in (2, 3)

    ck2 = finetune.main(["-c", cfg_path, "-d", "Toy", "--max_steps", "1",
                         "--max_val_batches", "2", "--pretrain_path", best, "--device", "cpu"])
    assert os.path.exists(os.path.join(ck2, "best_model.ckpt"))
    assert "warm start from" in open(glob_one(f"{root}/outputs/finetune_Toy_lr_0.0005_seed_20",
                                              "output.log")).read()

    # the warm start loads the pretrained parameters and keeps a fresh optimizer
    from zs_aac_tpu_torch.train.contrastive import create_ase_state
    from zs_aac_tpu_torch.train.optim import cosine_lr, get_optimizer

    ase, _ = pretrain.build_ase_from_config(config, device="cpu")
    opt = get_optimizer(cosine_lr(1e-3, 0, 4), "adam")
    fresh = create_ase_state(1, ase, opt, device="cpu")
    warm = restore_model_only(best, fresh)
    want = torch.load(best, map_location="cpu", weights_only=True)
    assert warm.step == 0 and warm.opt_state is fresh.opt_state
    torch.testing.assert_close(warm.params["audio_proj"]["fc1"]["kernel"],
                               want["params"]["audio_proj"]["fc1"]["kernel"], rtol=0, atol=0)
    torch.testing.assert_close(warm.batch_stats["audio_enc"]["bn0"]["var"],
                               want["batch_stats"]["audio_enc"]["bn0"]["var"], rtol=0, atol=0)


def test_extract_reads_the_pretrain_drivers_checkpoint(tmp_path, monkeypatch):
    """pretrain -> extract: the ``best_model.ckpt`` that ``pretrain.main`` writes
    loads in ``load_ase_encoders`` and encodes with the trained parameters."""
    from zs_aac_tpu_torch.pipeline.extract import load_ase_encoders

    monkeypatch.setenv("WANDB_MODE", "disabled")
    root = str(tmp_path)
    vocab = _mk_corpus(root, n_audio=8)
    config = _config(root, vocab)
    cfg_path = _write(config, f"{root}/config.yaml")
    ckpt_dir = pretrain.main(["-c", cfg_path, "--max_steps", "1", "--max_val_batches", "1",
                              "--device", "cpu"])
    best = os.path.join(ckpt_dir, "best_model.ckpt")
    extract_cfg = {**config, "training": {**config["training"], "spec_augmentation": False}}
    enc_a, enc_t = load_ase_encoders(extract_cfg, best, device="cpu")
    seeded_a, seeded_t = load_ase_encoders(extract_cfg, None, device="cpu")
    waves = np.random.default_rng(0).standard_normal((2, 32000)).astype(np.float32) * 0.1
    audio, text = enc_a(waves), enc_t(["a dog barks", "rain falls"])
    assert audio.shape == text.shape == (2, 16)
    assert np.isfinite(audio).all() and np.isfinite(text).all()
    np.testing.assert_allclose(np.linalg.norm(audio, axis=-1), 1.0, atol=1e-5)
    # the trained weights, not the seeded ones a missing checkpoint gives
    assert np.abs(audio - seeded_a(waves)).max() > 1e-3
    assert np.abs(text - seeded_t(["a dog barks", "rain falls"])).max() > 1e-3
    # and the same embeddings as the saved parameters give directly
    saved = torch.load(best, map_location="cpu", weights_only=True)
    again = str(tmp_path / "copy.ckpt")
    torch.save({"params": saved["params"], "batch_stats": saved["batch_stats"]}, again)
    np.testing.assert_array_equal(load_ase_encoders(extract_cfg, again, device="cpu")[0](waves),
                                  audio)


def test_drivers_default_to_cuda(tmp_path):
    assert pretrain.build_parser().parse_args(["-c", "x"]).device == "cuda"


def test_cuda_dispatch_ignores_the_host_device_count(tmp_path, monkeypatch):
    """On a CUDA device the extract and pretrain configs select the kernels
    (``fused_attn`` on, ``fused_block`` every stage but the last) whatever
    the host's device count; on the CPU they select none."""
    from zs_aac_tpu_torch.pipeline import extract

    assert extract.build_ase_from_config is pretrain.build_ase_from_config
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "configs", "extract_data.yaml")) as f:
        extract_cfg = yaml.safe_load(f)
    with open(os.path.join(here, "configs", "pretrain.yaml")) as f:
        pretrain_cfg = yaml.safe_load(f)
    pretrain_cfg["audio_encoder_args"]["type"] = "transformer"
    for config, n_stages in ((extract_cfg, 4), (pretrain_cfg, 4),
                             (_config(str(tmp_path), "vocab.txt"), 2)):
        _, cfg = pretrain.build_ase_from_config(config, device="cuda")
        assert cfg.audio_encoder == "htsat"
        assert cfg.fused_attn is True and cfg.fused_block == tuple(range(n_stages - 1))
        _, cfg = pretrain.build_ase_from_config(config, device="cpu")
        assert cfg.fused_attn is False and cfg.fused_block is False


def test_sampler_and_batches_match_jax(tmp_path):
    root = str(tmp_path)
    vocab = _mk_corpus(root, n_audio=12)
    lengths = list(np.random.default_rng(0).uniform(1, 29, 50))
    for seed in (20, 21):
        got = list(tsampler.BySequenceLengthSampler(lengths, (5, 30, 6), 4, seed=seed))
        want = list(jsampler.BySequenceLengthSampler(lengths, (5, 30, 6), 4, seed=seed))
        assert got == want
    for d in (0.5, 5.0, 7.3, 31.0):
        assert tsampler.bucket_pad_length(d) == jsampler.bucket_pad_length(d)

    audio = _config(root, vocab)["audio_args"]
    tds = tdata.AudioLanguagePretrainDataset([f"{root}/pretrain.json"], audio, None, 20)
    jds = jdata.AudioLanguagePretrainDataset([f"{root}/pretrain.json"], audio, None, 20)
    tt, jt = WordPieceTokenizer.from_file(vocab), JaxTokenizer.from_file(vocab)
    got = list(tdata.pretrain_batches(tds, tt, 4, seed=21))
    want = list(jdata.pretrain_batches(jds, jt, 4, seed=21))
    assert len(got) == len(want) >= 2

    def same(g, w):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "text":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)

    for g, w in zip(got, want):
        same(g, w)
    config = _config(root, vocab)
    tdm = tdata.AudioCaptionDataModule(config, "Toy", tt, root)
    jdm = jdata.AudioCaptionDataModule(config, "Toy", jt, root)
    for g, w in zip(list(tdm.train_batches(3)) + list(tdm.val_batches()),
                    list(jdm.train_batches(3)) + list(jdm.val_batches())):
        same(g, w)


@pytest.mark.parametrize("n_audio", [3, 40])
def test_recalls_match_jax(n_audio):
    rng = np.random.default_rng(n_audio)
    audio = rng.standard_normal((5 * n_audio, 16)).astype(np.float32)
    text = audio + rng.standard_normal(audio.shape).astype(np.float32) * 1.5
    for fn in ("t2a", "a2t"):
        got = getattr(tretrieval, fn)(audio, text)
        want = getattr(jretrieval, fn)(audio, text)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=f"{fn} {k}")


def _cnn14_config(root, vocab):
    """``_config`` with the tower of ``configs/pretrain.yaml`` and
    ``configs/train.yaml`` (``type: cnn``, ``model: Cnn14``) at two narrow
    blocks."""
    config = _config(root, vocab)
    config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14", "pretrained": False,
                                    "freeze": False}
    config["audio_channels"] = [4, 8]
    del config["htsat_kwargs"]
    return config


def test_cnn14_pretrain_and_finetune_drivers(tmp_path, monkeypatch):
    """The drivers on a Cnn14 config with ``--device cpu``: 2 pretraining
    steps move every BatchNorm's running statistics (13 in Cnn14; 5 at two
    blocks) and the finetune driver warm-starts from the checkpoint."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    root = str(tmp_path)
    vocab = _mk_corpus(root, n_audio=8)
    config = _cnn14_config(root, vocab)
    cfg_path = _write(config, f"{root}/config.yaml")
    ckpt_dir = pretrain.main(["-c", cfg_path, "--max_steps", "2", "--max_val_batches", "2",
                              "--device", "cpu"])
    best = os.path.join(ckpt_dir, "best_model.ckpt")
    saved = torch.load(best, map_location="cpu", weights_only=True)
    assert saved["step"] == 2 and "Cnn14" in ckpt_dir
    stats = saved["batch_stats"]["audio_enc"]
    assert sorted(stats) == ["bn0", "conv_block1", "conv_block2"]
    for bn in (stats["bn0"], stats["conv_block1"]["bn1"], stats["conv_block2"]["bn2"]):
        assert not torch.equal(bn["mean"], torch.zeros_like(bn["mean"]))
        assert not torch.equal(bn["var"], torch.ones_like(bn["var"]))
    ck2 = finetune.main(["-c", cfg_path, "-d", "Toy", "--max_steps", "1",
                         "--max_val_batches", "2", "--pretrain_path", best, "--device", "cpu"])
    assert os.path.exists(os.path.join(ck2, "best_model.ckpt"))
    assert "warm start from" in open(glob_one(f"{root}/outputs/finetune_Toy_lr_0.0005_seed_20",
                                              "output.log")).read()


@pytest.mark.parametrize("model", ["Cnn14", "ResNet38"])
def test_load_pretrained_encoder_reads_panns_checkpoints(model, tmp_path):
    """``audio_encoder_args.pretrained_path``: a PANNs-layout state dict
    (under ``"model"``, with the ``fc`` head and the extractors, which are
    skipped) lands in the audio tower's variables."""
    from test_cnns import _TorchMiniCnn
    from test_torch_cnns import _TorchResNet38, _randomize_torch
    from zs_aac_tpu_torch.models.convert import convert_cnn, convert_resnet38
    from zs_aac_tpu_torch.train.contrastive import create_ase_state
    from zs_aac_tpu_torch.train.optim import cosine_lr, get_optimizer

    vocab = _mk_corpus(str(tmp_path), n_audio=2)
    config = _cnn14_config(str(tmp_path), vocab)
    if model == "ResNet38":
        config["audio_encoder_args"]["model"] = "ResNet38"
        config["audio_args"]["n_mels"] = 32
        ref = _TorchResNet38((3, 4, 6, 3), 32)
    else:
        ref = _TorchMiniCnn((4, 8))
    _randomize_torch(ref, 0)
    sd = dict(ref.state_dict())
    sd["fc_audioset.weight"] = torch.zeros(3, 3)
    sd["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(3)
    path = str(tmp_path / "panns.pth")
    torch.save({"model": sd}, path)
    config["audio_encoder_args"].update(pretrained=True, pretrained_path=path)
    ase, _ = pretrain.build_ase_from_config(config, device="cpu")
    state = create_ase_state(0, ase, get_optimizer(cosine_lr(1e-3, 0, 4), "adam"), device="cpu")
    state = pretrain.load_pretrained_encoder(state, config, "cpu")
    want = (convert_resnet38(sd, device="cpu") if model == "ResNet38"
            else convert_cnn(sd, n_blocks=2, device="cpu"))
    for part, tree in (("params", state.params["audio_enc"]),
                       ("batch_stats", state.batch_stats["audio_enc"])):
        torch.testing.assert_close(tree, want[part], rtol=0, atol=0)
