"""The PyTorch port stands alone: it imports neither JAX, flax, optax nor the
JAX package, and its entry points run on CUDA unless told otherwise."""

import inspect
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zs_aac_tpu_torch
from zs_aac_tpu_torch.decoding import magic
from zs_aac_tpu_torch.eval import zero_shot
from zs_aac_tpu_torch.models import (ase, bert, caption, caption_mistral, cnns, convert, gpt2,
                                     htsat, mapper, mistral, text_towers)
from zs_aac_tpu_torch.parallel import dryrun as parallel_dryrun
from zs_aac_tpu_torch.parallel import mesh as parallel_mesh
from zs_aac_tpu_torch.parallel import tp as parallel_tp
from zs_aac_tpu_torch.pipeline import extract, related
from zs_aac_tpu_torch.train import (caption_trainer, contrastive, finetune, optim,
                                    predict_multilingual, predict_prompt, pretrain, train_prompt,
                                    train_prompt_multilingual)
from zs_aac_tpu_torch.utils import device as device_mod
from zs_aac_tpu_torch.utils import memory, profiling

PKG = Path(zs_aac_tpu_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "zs_aac_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    kernels = {"zs_aac_tpu_torch.ops." + m
               for m in ("decode_attn", "logmel", "window_attn", "specaug")}
    train = {"zs_aac_tpu_torch.train." + m for m in ("optim", "pretrain", "finetune",
                                                     "train_prompt", "caption_trainer")}
    captioner = {"zs_aac_tpu_torch." + m for m in ("pipeline.related", "utils.noise",
                                                   "utils.memory", "data.prompts")}
    multilingual = {"zs_aac_tpu_torch." + m for m in (
        "data.sentencepiece", "models.mistral", "models.caption_mistral",
        "train.predict_multilingual", "train.train_prompt_multilingual")}
    slice13 = {"zs_aac_tpu_torch." + m for m in (
        "models.text_towers", "pipeline.prepare", "pipeline.synthesize", "utils.config",
        "utils.profiling", "utils.types")}
    parallel = {"zs_aac_tpu_torch.parallel." + m for m in ("mesh", "tp", "dryrun")}
    assert {parallel_mesh.__name__, parallel_tp.__name__, parallel_dryrun.__name__} == parallel
    assert (kernels | train | captioner | multilingual | slice13 | parallel <= set(mods)
            and len(mods) >= 68)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'zs_aac_tpu'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("module", ["zs_aac_tpu_torch.models.cnns",
                                    "zs_aac_tpu_torch.eval.zero_shot",
                                    "zs_aac_tpu_torch.train.train_prompt",
                                    "zs_aac_tpu_torch.train.caption_trainer",
                                    "zs_aac_tpu_torch.pipeline.related",
                                    "zs_aac_tpu_torch.utils.noise",
                                    "zs_aac_tpu_torch.utils.memory",
                                    "zs_aac_tpu_torch.data.prompts",
                                    "zs_aac_tpu_torch.data.sentencepiece",
                                    "zs_aac_tpu_torch.models.mistral",
                                    "zs_aac_tpu_torch.models.caption_mistral",
                                    "zs_aac_tpu_torch.train.predict_multilingual",
                                    "zs_aac_tpu_torch.train.train_prompt_multilingual",
                                    "zs_aac_tpu_torch.models.text_towers",
                                    "zs_aac_tpu_torch.models.ase",
                                    "zs_aac_tpu_torch.pipeline.prepare",
                                    "zs_aac_tpu_torch.pipeline.synthesize",
                                    "zs_aac_tpu_torch.pipeline.extract",
                                    "zs_aac_tpu_torch.train.pretrain",
                                    "zs_aac_tpu_torch.train.finetune",
                                    "zs_aac_tpu_torch.utils.config",
                                    "zs_aac_tpu_torch.utils.profiling",
                                    "zs_aac_tpu_torch.utils.types",
                                    "zs_aac_tpu_torch.parallel.mesh",
                                    "zs_aac_tpu_torch.parallel.tp",
                                    "zs_aac_tpu_torch.parallel.dryrun",
                                    "examples/end_to_end_toy_torch.py"])
def test_slice_modules_import_no_jax_pandas_or_yaml(module):
    """The PANNs towers, the zero-shot CLI, the captioner's training modules,
    the Mistral captioner's, the text towers, the host pipeline, the config
    reader, the profiling utilities, the multi-GPU modules and the port's
    end-to-end toy load in a fresh interpreter without JAX, flax, optax, the JAX package, pandas or
    yaml (the card machine has neither of the last two)."""
    load = (f"runpy.run_path({module!r}, run_name='toy')" if module.endswith(".py")
            else f"importlib.import_module({module!r})")
    code = (f"import importlib, runpy, sys; {load}; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'optax', 'zs_aac_tpu', 'pandas', 'yaml'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_name_no_jax_package():
    bad = re.compile(r"\bzs_aac_tpu\.|^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "examples" / "end_to_end_toy_torch.py"]
    hits = [str(p.relative_to(REPO)) for p in files if bad.search(p.read_text())]
    assert not hits, hits


_HTSAT_ASE = ase.ASEConfig(audio_encoder="htsat")
_CAPTION = caption.CaptionConfig(prefix_size=8, prefix_length=2,
                                 gpt2=gpt2.GPT2Config(vocab_size=8, n_positions=8, n_embd=8,
                                                      n_layer=1, n_head=2))
_ADAM = optim.get_optimizer(lambda step: 1e-3, "adam")
_MISTRAL = mistral.MistralConfig(vocab_size=8, hidden_size=8, n_layers=1, n_heads=2, n_kv_heads=1,
                                 intermediate_size=8)
_MISTRAL_CAPTION = caption_mistral.MistralCaptionConfig(prefix_size=8, prefix_length=2,
                                                        mistral=_MISTRAL)

# name -> (function, a call of it that takes the default device)
ENTRY_POINTS = {
    "from_jax_params": (convert.from_jax_params, lambda: convert.from_jax_params({})),
    "init_gpt2": (gpt2.init_gpt2, lambda: gpt2.init_gpt2(gpt2.GPT2Config())),
    "convert_gpt2": (gpt2.convert_gpt2, lambda: gpt2.convert_gpt2({}, gpt2.GPT2Config())),
    "init_kv_cache": (gpt2.init_kv_cache,
                      lambda: gpt2.init_kv_cache(gpt2.GPT2Config(), 1, 4)),
    "init_kv_cache_q8": (gpt2.init_kv_cache_q8,
                         lambda: gpt2.init_kv_cache_q8(gpt2.GPT2Config(), 1, 4)),
    "make_mapper": (mapper.make_mapper, lambda: mapper.make_mapper("mlp", 8, 8, 2)),
    "init_caption_model": (caption.init_caption_model,
                           lambda: caption.init_caption_model(caption.CaptionConfig())),
    "resolve_device": (device_mod.resolve_device, lambda: device_mod.resolve_device()),
    "init_ase": (ase.init_ase, lambda: ase.init_ase(_HTSAT_ASE)),
    "from_jax_params(ase)": (convert.from_jax_params,
                             lambda: convert.from_jax_params({"params": {}})),
    "convert_ase": (convert.convert_ase, lambda: convert.convert_ase({}, _HTSAT_ASE)),
    "convert_htsat": (convert.convert_htsat, lambda: convert.convert_htsat({})),
    "convert_bert": (bert.convert_bert, lambda: bert.convert_bert({}, bert.BertConfig())),
    "HTSAT.init": (htsat.HTSAT.init, lambda: htsat.HTSAT().init()),
    "Cnn14.init": (cnns.Cnn14.init, lambda: cnns.Cnn14(channels=(2,)).init()),
    "ResNet38.init": (cnns.ResNet38.init, lambda: cnns.ResNet38(layers=(1, 1, 1, 1)).init()),
    "convert_cnn": (convert.convert_cnn, lambda: convert.convert_cnn({}, 1)),
    "convert_resnet38": (convert.convert_resnet38, lambda: convert.convert_resnet38({})),
    "init_ase(cnn14)": (ase.init_ase, lambda: ase.init_ase(ase.ASEConfig(audio_channels=(2,)))),
    "zero_shot": (zero_shot.zero_shot, lambda: zero_shot.zero_shot({}, {}, "esc50", "x")),
    "load_ase_encoders": (extract.load_ase_encoders, lambda: extract.load_ase_encoders({})),
    "make_encode_fns": (contrastive.make_encode_fns,
                        lambda: contrastive.make_encode_fns(ase.ASE(_HTSAT_ASE))),
    "create_ase_state": (contrastive.create_ase_state,
                         lambda: contrastive.create_ase_state(0, ase.ASE(_HTSAT_ASE), _ADAM)),
    "make_ase_train_step": (contrastive.make_ase_train_step,
                            lambda: contrastive.make_ase_train_step(ase.ASE(_HTSAT_ASE), _ADAM)),
    "pretrain.run": (pretrain.run, lambda: pretrain.run({})),
    "make_magic_scorer": (magic.make_magic_scorer,
                          lambda: magic.make_magic_scorer("ase.msgpack", None)),
    "init_cross_attention": (caption.init_cross_attention,
                             lambda: caption.init_cross_attention(_CAPTION)),
    "create_caption_state": (caption_trainer.create_caption_state,
                             lambda: caption_trainer.create_caption_state(0, _CAPTION, _ADAM)),
    "make_caption_train_step": (caption_trainer.make_caption_train_step,
                                lambda: caption_trainer.make_caption_train_step(_CAPTION, _ADAM)),
    "construct_support_memory": (memory.construct_support_memory,
                                 lambda: memory.construct_support_memory([])),
    "attach_related": (related.attach_related,
                       lambda: list(related.attach_related(np.zeros((2, 4), np.float32), []))),
    "run_validation": (train_prompt.run_validation,
                       lambda: train_prompt.run_validation({}, _CAPTION, [], None, 0, {})),
    "init_mistral": (mistral.init_mistral, lambda: mistral.init_mistral(_MISTRAL)),
    "convert_mistral": (mistral.convert_mistral,
                        lambda: mistral.convert_mistral({}, _MISTRAL)),
    "init_lora": (mistral.init_lora, lambda: mistral.init_lora(_MISTRAL)),
    "init_mistral_cache": (mistral.init_mistral_cache,
                           lambda: mistral.init_mistral_cache(_MISTRAL, 1, 4)),
    "init_mistral_cache_q8": (mistral.init_mistral_cache_q8,
                              lambda: mistral.init_mistral_cache_q8(_MISTRAL, 1, 4)),
    "init_mistral_caption": (caption_mistral.init_mistral_caption,
                             lambda: caption_mistral.init_mistral_caption(_MISTRAL_CAPTION)),
    "make_multilingual_train_step": (
        train_prompt_multilingual.make_multilingual_train_step,
        lambda: train_prompt_multilingual.make_multilingual_train_step(_MISTRAL_CAPTION, _ADAM)),
    "init_gpt2_encoder": (text_towers.init_gpt2_encoder, lambda: text_towers.init_gpt2_encoder(
        text_towers.GPT2EncoderConfig(n_layer=1), torch.Generator())),
    "init_clip_text": (text_towers.init_clip_text, lambda: text_towers.init_clip_text(
        text_towers.CLIPTextConfig(n_layer=1), torch.Generator())),
    "convert_gpt2_encoder": (text_towers.convert_gpt2_encoder,
                             lambda: text_towers.convert_gpt2_encoder(
                                 {}, text_towers.GPT2EncoderConfig())),
    "convert_clip_text": (text_towers.convert_clip_text, lambda: text_towers.convert_clip_text(
        {}, text_towers.CLIPTextConfig())),
    "init_ase(gpt2)": (ase.init_ase, lambda: ase.init_ase(ase.ASEConfig(
        audio_channels=(2,), text_model="gpt2-tiny"))),
    "StepTimer": (profiling.StepTimer, lambda: profiling.StepTimer()),
    "trace": (profiling.trace, lambda: profiling.trace("x").__enter__()),
    "device_memory_stats": (profiling.device_memory_stats,
                            lambda: profiling.device_memory_stats()),
    "init_distributed": (parallel_mesh.init_distributed,
                         lambda: parallel_mesh.init_distributed()),
    "run_multilingual_validation": (
        train_prompt_multilingual.run_multilingual_validation,
        lambda: train_prompt_multilingual.run_multilingual_validation(
            {"mistral": {"lm_head": None}}, _MISTRAL_CAPTION, [], None, {})),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_predict_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    args = predict_prompt.build_parser().parse_args(["--test_dir", "x", "--data", "y"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_prompt.main(["--test_dir", str(tmp_path), "--data", "none.pkl"])


def test_caption_drivers_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    args = train_prompt.build_parser().parse_args(["--data", "x", "--valdata", "y"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_prompt.main(["--data", "none.pkl", "--valdata", "none.pkl",
                           "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        related.main(["--input_path", "none.pkl", "--output_path", str(tmp_path / "o.pkl")])


@pytest.mark.parametrize("driver", ["predict", "train"])
def test_multilingual_drivers_default_to_cuda_and_raise_without_it(driver, monkeypatch,
                                                                   tmp_path):
    if driver == "predict":
        mod, argv = predict_multilingual, ["--test_dir", str(tmp_path), "--data", "none.pkl"]
    else:
        mod, argv = train_prompt_multilingual, ["--data", "none.pkl", "--valdata", "none.pkl",
                                                "--out_dir", str(tmp_path)]
    assert mod.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())


def test_extract_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    args = extract.build_parser().parse_args(["--out_path", "x"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract.main(["--out_path", str(tmp_path / "bank.pkl"), "--config", "none.yaml"])


@pytest.mark.parametrize("driver", [pretrain, finetune])
def test_train_drivers_default_to_cuda_and_raise_without_it(driver, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["-c", str(tmp_path / "none.yaml")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.main(["-c", str(tmp_path / "none.yaml"), "--device", "cuda"])


@pytest.mark.parametrize("env", [{}, {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                                      "MASTER_ADDR": "localhost", "MASTER_PORT": "29400"}])
def test_init_distributed_cuda_raises_without_a_card(env, monkeypatch):
    """``init_distributed("cuda")`` raises where there is no card, with or
    without a ``torchrun`` environment: it never carries on over gloo or on
    the CPU, and it joins no group on the way."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel_mesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_init_distributed_cuda_raises_without_nccl(monkeypatch):
    """A card but no NCCL under ``torchrun``: ``cuda`` raises."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        parallel_mesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()
