"""``examples/convert_jax_state.py``: the JAX package's orbax train states
carried into the port's train-state file, and the port's readers refusing a
directory.

- Model-only, a tiny Cnn14 and a tiny HTSAT ASE (the tiny-ASE fixture's
  config; JAX's HTSAT class swapped for one at the config's sizes, as
  ``test_torch_zero_shot.py::_tiny_jax_htsat`` does): a seeded JAX state
  saved by the JAX package's ``save_train_state`` goes through the converter;
  ``load_ase_variables`` gives JAX's params and batch statistics bitwise,
  and the port's ``extract`` on the file gives the JAX package's ``extract``
  on the directory within ``test_torch_extract.py``'s tolerance.
- The full state: a JAX state after 2 train steps (tiny Cnn14 at dropout 0,
  Adam under a global-norm clip, the tiny-ASE fixture's batch) saved by orbax
  and converted restores into the port's template with every leaf bitwise
  (params, batch statistics, Adam's ``mu``/``nu``/``count``, the schedule's
  ``count``, ``step``); one more step in each package then agrees within
  ``test_torch_train_step.py``'s tolerance: the loss within 1e-4 relative,
  each leaf within 1e-4 of its size, the batch statistics within 1e-5. The
  two attention key biases are held apart, as ``test_torch_cnn_ase.py``
  holds them: their exact gradient is 0, so Adam steps them by up to the
  learning rate on each package's rounding noise.
- Every reader of a train state, given a directory, raises a ``ValueError``
  that names the converter.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_bert_ase import register_tiny_bert_in_jax, tiny_registry  # noqa: F401
from test_torch_cnn_ase import CHANNELS, _no_dropout, cnn_reference_state_dict
from test_torch_extract import TOL, absolute_manifest, assert_banks_match, make_dataset
from zs_aac_tpu.models import htsat as jhtsat
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.utils.checkpoints import (load_ase_variables, restore_model_only,
                                                restore_train_state, save_train_state)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import convert_jax_state as conv  # noqa: E402

torch.set_num_threads(2)

OPTIM = {"optim_args": {"lr": 1e-3, "optimizer_name": "adam"},
         "training": {"epochs": 4, "warmup_epochs": 1, "clip_grad": 2.0,
                      "spec_augmentation": False}}


def _config(tower):
    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    config["text_encoder_args"]["vocab"] = str(testdata.TINY_ASE_DIR / "vocab.txt")
    if tower == "cnn14":
        config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14"}
        config["audio_channels"] = list(CHANNELS)
    return {**config, **OPTIM}


def _tiny_jax_htsat(monkeypatch, config):
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config["htsat_kwargs"].items()}
    monkeypatch.setattr(jhtsat, "HTSAT", type("TinyHTSAT", (jhtsat.HTSAT,), {
        "__annotations__": {k: type(v) for k, v in kw.items()}, **kw}))


def _filled(abstract, have, rng):
    """``abstract`` (shapes and dtypes) with the leaves of ``have`` where it
    has them, seeded random values elsewhere."""
    if isinstance(abstract, dict):
        return {k: _filled(v, have.get(k) if isinstance(have, dict) else None, rng)
                for k, v in abstract.items()}
    if have is not None:
        return jnp.asarray(have)
    return jnp.asarray((0.02 * rng.standard_normal(abstract.shape)).astype(abstract.dtype))


def _jax_state(config, sd, path, steps=0):
    """The JAX train state of ``config`` after ``steps`` train steps on the
    fixture's batch, saved to ``path`` by the JAX package's
    ``save_train_state``: the tree of the JAX package's init, its leaves the
    reference-layout weights ``sd`` where they have them and seeded random
    values where not (the tiny HTSAT's ``ase.pt`` has no ``tscam_conv``).
    Returns (state, the JAX step, the batch)."""
    from zs_aac_tpu.models.convert import convert_ase
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train.contrastive import (ASETrainState, create_ase_state,
                                              make_ase_train_step)
    from zs_aac_tpu.train.pretrain import build_ase_from_config
    from zs_aac_tpu.utils.checkpoints import save_train_state as jax_save

    opt, _ = conv._optimizers(config, "pretrain")
    ase, cfg = build_ase_from_config(config)
    mel = LogMelConfig.from_dict(config["audio_args"])
    init = jax.eval_shape(lambda: create_ase_state(jax.random.key(0), ase, opt,
                                                   spec_shape=(2, 101, mel.n_mels), text_len=30))
    variables = convert_ase(sd, cfg)
    rng = np.random.default_rng(7)
    params = _filled(init.params, variables["params"], rng)
    state = ASETrainState(params, _filled(init.batch_stats, variables["batch_stats"], rng),
                          opt.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(make_ase_train_step(ase, opt, mel, mel_impl="xla"))
    batch = {k: jnp.asarray(v) for k, v in testdata.train_batch().items()} if steps else None
    for _ in range(steps):
        state, _ = step(state, batch, jax.random.key(0))
    jax_save(path, state)
    return state, step, batch


def _convert(jpath, config, tmp_path):
    tpath = str(tmp_path / "converted.ckpt")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(config))
    assert conv.main(["-c", str(cfg_path), "--orbax_dir", jpath, "--out", tpath]) == tpath
    return tpath


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix: np.asarray(tree)}


def _assert_bitwise(got, want, min_leaves=1):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want) and len(want) >= min_leaves
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def cnn_run(tmp_path_factory):
    """A tiny Cnn14 ASE's JAX state after 2 train steps, saved by orbax and
    converted (Cnn14 at dropout 0 in both packages while the module runs)."""
    with pytest.MonkeyPatch.context() as mp:
        register_tiny_bert_in_jax(mp.setitem)
        _no_dropout(mp)
        root = tmp_path_factory.mktemp("cnn_run")
        config = _config("cnn14")
        jpath = str(root / "jax_state")
        state, step, batch = _jax_state(config, cnn_reference_state_dict(seed=4), jpath, steps=2)
        yield {"config": config, "jpath": jpath, "tpath": _convert(jpath, config, root),
               "state": state, "step": step, "batch": batch}


def _extract_matches_jax(config, jpath, tpath, root):
    """The port's ``extract`` on the converted file against the JAX
    package's on the directory."""
    from zs_aac_tpu.pipeline import extract as jax_extract
    from zs_aac_tpu_torch.pipeline import extract as port_extract

    data = str(root / "bank")
    make_dataset(data, n=3)
    absolute_manifest(data)
    want = jax_extract.extract_audio_text_bank(*jax_extract.load_ase_encoders(config, jpath),
                                               data, True, config["audio_args"], 3)
    ea, et = port_extract.load_ase_encoders(config, tpath, device="cpu")
    got = port_extract.extract_audio_text_bank(ea, et, data, True, config["audio_args"],
                                               batch_size=3)
    assert_banks_match(got, want, tol=TOL)


def _model_only_matches_jax(config, state, tpath):
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    _, cfg = build_ase_from_config(config, device="cpu")
    got = load_ase_variables(tpath, cfg, device="cpu")
    _assert_bitwise(got, jax.device_get({"params": state.params,
                                         "batch_stats": state.batch_stats}), min_leaves=20)


def test_model_only_cnn14(cnn_run, tmp_path):
    _model_only_matches_jax(cnn_run["config"], cnn_run["state"], cnn_run["tpath"])
    _extract_matches_jax(cnn_run["config"], cnn_run["jpath"], cnn_run["tpath"], tmp_path)


def test_model_only_htsat(tmp_path, monkeypatch, tiny_registry):  # noqa: F811
    config = _config("htsat")
    _tiny_jax_htsat(monkeypatch, config)
    sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    jpath = str(tmp_path / "jax_state")
    state, _, _ = _jax_state(config, sd, jpath)
    tpath = _convert(jpath, config, tmp_path)
    _model_only_matches_jax(config, state, tpath)
    _extract_matches_jax(config, jpath, tpath, tmp_path)


def test_full_state_restores_bitwise_and_resumes_as_jax(cnn_run):
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    config, state = cnn_run["config"], cnn_run["state"]
    payload = torch.load(cnn_run["tpath"], map_location="cpu", weights_only=True)
    assert set(payload) == {"params", "batch_stats", "opt_state", "step"}
    _, port_opt = conv._optimizers(config, "pretrain")
    ase, _ = build_ase_from_config(config, device="cpu")
    template = create_ase_state(0, ase, port_opt, device="cpu")
    restored = restore_train_state(cnn_run["tpath"], template)
    assert restored.step == int(state.step) == 2
    want = jax.device_get(state)
    _assert_bitwise(restored.params, want.params, min_leaves=20)
    _assert_bitwise(restored.batch_stats, want.batch_stats, min_leaves=2)
    clip, (adam, schedule) = restored.opt_state
    assert clip == {} and not want.opt_state[0]
    _assert_bitwise(adam, want.opt_state[1][0]._asdict(), min_leaves=40)
    _assert_bitwise(schedule, want.opt_state[1][1]._asdict())
    assert int(adam["count"]) == int(schedule["count"]) == 2

    want3, want_loss = jax.device_get(cnn_run["step"](state, cnn_run["batch"],
                                                      jax.random.key(0)))
    step = make_ase_train_step(ase, port_opt, LogMelConfig.from_dict(config["audio_args"]),
                               device="cpu")
    got3, got_loss = step(restored, testdata.train_batch(), 0)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-4)
    assert got3.step == 3
    mine, ref, before = _leaves(got3.params), _leaves(want3.params), _leaves(want.params)
    lr = config["optim_args"]["lr"]
    key_bias = [k for k in ref if k.endswith("key/bias/")]
    assert len(key_bias) == 2
    for k, w in ref.items():
        if k in key_bias:
            assert np.abs(mine[k] - before[k]).max() <= lr * 1.01, k
        else:
            np.testing.assert_allclose(mine[k], w, rtol=0, atol=1e-4 * (np.abs(w).max() + 1e-12),
                                       err_msg=k)
    got_stats = _leaves(got3.batch_stats)
    for k, w in _leaves(want3.batch_stats).items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"audio_enc": {"w": f(4, 3), "b": f(3)}, "text_enc": {"w": f(5)},
            "proj": {"w": f(3, 2)}, "temp": np.float32(0.07)}


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("driver,freeze", [("pretrain", False), ("pretrain", True),
                                           ("finetune", False)])
def test_every_optimizer_chain_maps_onto_the_port_layout(opt, driver, freeze):
    """Each driver's chain (clip, the freezes' masked multi-transform, each
    optimizer): optax's state after two updates of a toy tree, mapped by the
    converter, is a state the port's optimizer takes; its third update
    matches optax's (``test_torch_train_step.py``'s optimizer tolerance)."""
    import optax

    from zs_aac_tpu_torch.train import optim as topt

    config = {"optim_args": {"lr": 0.1, "optimizer_name": opt,
                             "weight_decay": 0.05 if opt == "adamw" else 0.0},
              "training": {"epochs": 4, "warmup_epochs": 1, "clip_grad": 1.0},
              "audio_encoder_args": {"freeze": freeze}, "text_encoder_args": {}}
    jo, to = conv._optimizers(config, driver)
    jp = jax.tree.map(jnp.asarray, _toy_tree(0))
    js = jo.init(jp)
    grads = [jax.tree.map(lambda x: x * (3.0 if i == 1 else 0.5), _toy_tree(10 + i))
             for i in range(3)]
    for g in grads[:2]:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
    tp = {k: v for k, v in _leaves_as_tensors(jax.device_get(jp)).items()}
    ts = conv._opt_state(jax.device_get(js), to.init(tp))
    ju, js = jo.update(jax.tree.map(jnp.asarray, grads[2]), js, jp)
    tu, ts = to.update(_leaves_as_tensors(grads[2]), ts, tp)
    want, got = _leaves(optax.apply_updates(jp, ju)), _leaves(topt.apply_updates(tp, tu))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="unknown driver"):
        conv._optimizers(config, "train_prompt")


def _leaves_as_tensors(tree):
    return {k: _leaves_as_tensors(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("reader", ["restore_train_state", "restore_model_only",
                                    "load_ase_variables", "extract", "zero_shot"])
def test_readers_refuse_a_directory_naming_the_converter(reader, tmp_path):
    orbax_dir = tmp_path / "best_model"
    orbax_dir.mkdir()
    config = _config("cnn14")
    if reader == "restore_train_state":
        call = lambda: restore_train_state(str(orbax_dir), None)           # --resume_ckpt
    elif reader == "restore_model_only":
        call = lambda: restore_model_only(str(orbax_dir), None)            # pretrain_path
    elif reader == "load_ase_variables":
        call = lambda: load_ase_variables(str(orbax_dir), None, device="cpu")
    elif reader == "extract":
        from zs_aac_tpu_torch.pipeline import extract

        call = lambda: extract.load_ase_encoders(config, str(orbax_dir), device="cpu")
    else:
        from zs_aac_tpu_torch.eval import zero_shot

        cfg_path = tmp_path / "config.json"
        cfg_path.write_text(json.dumps(config))
        call = lambda: zero_shot.main(["-c", str(cfg_path), "--ckpt", str(orbax_dir),
                                       "--dataset", "esc50", "--data_root", str(tmp_path),
                                       "--device", "cpu"])
    with pytest.raises(ValueError, match="examples/convert_jax_state.py"):
        call()
    with pytest.raises(ValueError, match=str(orbax_dir)):
        call()
