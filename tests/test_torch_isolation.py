"""The PyTorch port stands alone: it imports neither JAX, flax, optax nor the
JAX package, and its entry points run on CUDA unless told otherwise."""

import inspect
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import zs_aac_tpu_torch
from zs_aac_tpu_torch.models import ase, bert, caption, convert, gpt2, htsat, mapper
from zs_aac_tpu_torch.pipeline import extract
from zs_aac_tpu_torch.train import contrastive, finetune, optim, predict_prompt, pretrain
from zs_aac_tpu_torch.utils import device as device_mod

PKG = Path(zs_aac_tpu_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "zs_aac_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    kernels = {"zs_aac_tpu_torch.ops." + m
               for m in ("decode_attn", "logmel", "window_attn", "specaug")}
    train = {"zs_aac_tpu_torch.train." + m for m in ("optim", "pretrain", "finetune")}
    assert kernels | train <= set(mods) and len(mods) >= 47
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'zs_aac_tpu'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_name_no_jax_package():
    bad = re.compile(r"\bzs_aac_tpu\.|^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    hits = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py") if bad.search(p.read_text())]
    assert not hits, hits


_HTSAT_ASE = ase.ASEConfig(audio_encoder="htsat")
_ADAM = optim.get_optimizer(lambda step: 1e-3, "adam")

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
    "load_ase_encoders": (extract.load_ase_encoders, lambda: extract.load_ase_encoders({})),
    "make_encode_fns": (contrastive.make_encode_fns,
                        lambda: contrastive.make_encode_fns(ase.ASE(_HTSAT_ASE))),
    "create_ase_state": (contrastive.create_ase_state,
                         lambda: contrastive.create_ase_state(0, ase.ASE(_HTSAT_ASE), _ADAM)),
    "make_ase_train_step": (contrastive.make_ase_train_step,
                            lambda: contrastive.make_ase_train_step(ase.ASE(_HTSAT_ASE), _ADAM)),
    "pretrain.run": (pretrain.run, lambda: pretrain.run({})),
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


@pytest.mark.parametrize("flag", ["--bf16_softmax", "--magic", "--q8_tower"])
def test_predict_later_slices_raise(flag, tmp_path):
    (tmp_path / "params.json").write_text('{"data": [], "prefix_length": 4}')
    with pytest.raises(NotImplementedError, match="later slice"):
        predict_prompt.main(["--test_dir", str(tmp_path), "--data", "none.pkl",
                             "--device", "cpu", flag])


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
