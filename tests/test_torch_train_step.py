"""The port's contrastive training pieces against the JAX package's: the
losses, the schedules, the optimizers (against optax), and the whole train
step (``make_ase_train_step``) on the committed tiny ASE.

Tolerances (fp32): losses 1e-6 relative, schedules 1e-6 relative or 1e-6 of
the base rate (the JAX schedule evaluates its cosine in float32, ~1e-7 of
its range; the port's in float64);
optimizer updates 1e-6 relative / 1e-9 absolute. The 3-step train run agrees
to ~1e-5 relative in the losses and the parameters: the gradients differ in
summation order (~1e-6), and Adam divides each by its own running scale,
which carries that relative noise into every update; held at 1e-4 relative
(losses) and 1e-4 of each leaf's size (parameters, batch statistics).

``PYTHONPATH=. python tests/test_torch_train_step.py --write-fixture``
rewrites ``zs_aac_tpu_torch/testdata/tiny_ase/train_expected.json`` from the
JAX package's train step.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_bert_ase import (ase_config_kwargs, register_tiny_bert_in_jax,  # noqa: F401
                                 tiny_registry)
from zs_aac_tpu.models import ase as jase
from zs_aac_tpu.train import optim as jopt
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.models import ase as tase
from zs_aac_tpu_torch.train import optim as topt
from zs_aac_tpu_torch.train.pretrain import apply_freeze

torch.set_num_threads(2)

EXPECTED = testdata.TINY_ASE_DIR / "train_expected.json"


def _sims(seed=0, n=6, d=8):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d)).astype(np.float32)
    t = rng.standard_normal((n, d)).astype(np.float32)
    idx = np.asarray([0, 0, 1, 2, 2, 3])
    pos = (idx[:, None] == idx[None, :]).astype(np.float32)
    return a, t, pos / pos.sum(1, keepdims=True)


def test_losses_match_jax():
    a, t, targets = _sims()
    for tgt in (None, targets):
        want = float(jase.atc_loss(jnp.asarray(a @ t.T), jnp.asarray(t @ a.T),
                                   None if tgt is None else jnp.asarray(tgt)))
        got = tase.atc_loss(torch.from_numpy(a @ t.T), torch.from_numpy(t @ a.T),
                            None if tgt is None else torch.from_numpy(tgt)).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(jase.ntxent_loss(jnp.asarray(a), jnp.asarray(t), 0.1))
    got = tase.ntxent_loss(torch.from_numpy(a), torch.from_numpy(t), 0.1).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_ase_loss_matches_jax(train, tiny_registry):
    """``ASE.__call__`` on the tiny ASE (fp32): multi-positive targets from
    the audio ids, the learnable temperature and the embedding
    regularization; in train mode (batch statistics, no spec augmentation or
    drop path in this config) the new batch statistics too."""
    from zs_aac_tpu.models.convert import convert_ase as jax_convert
    from zs_aac_tpu_torch.models.convert import convert_ase

    cfg_j = jase.ASEConfig(**ase_config_kwargs())
    cfg_t = tase.ASEConfig(**ase_config_kwargs())
    sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    batch = testdata.train_batch()
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((len(batch["idx"]), 101, 16)).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, jax_convert(sd, cfg_j))
    args = (spec, batch["input_ids"], batch["attention_mask"], batch["idx"])
    out = jase.ASE(cfg_j).apply(jv, *map(jnp.asarray, args), train=train,
                                mutable=["batch_stats"] if train else False)
    want, want_stats = out if train else (out, None)
    got, stats = tase.ASE(cfg_t)(convert_ase(sd, cfg_t, device="cpu"),
                                 *map(torch.from_numpy, args), train=train)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    if train:
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats["audio_enc"]["bn0"][k].numpy(),
                                       np.asarray(want_stats["batch_stats"]["audio_enc"]["bn0"][k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,args", [("cosine_lr", (1e-3, 3, 12)), ("cosine_lr", (5e-5, 0, 7)),
                                       ("step_lr", (1e-3, 2, 3, 0.1)),
                                       ("linear_warmup_lr", (1e-3, 4, 10))])
def test_schedules_match_jax(name, args):
    want = getattr(jopt, name)(*args)
    got = getattr(topt, name)(*args)
    for step in range(15):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-6 * args[0], err_msg=f"step {step}")


def _toy_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"audio_enc": {"w": f(4, 3), "b": f(3)}, "text_enc": {"w": f(5)},
            "proj": {"w": f(3, 2)}, "temp": np.float32(0.07)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
@pytest.mark.parametrize("freeze", [False, True])
def test_optimizers_match_optax(opt, clip, freeze):
    """Three updates of ``get_optimizer`` (+ clip by global norm, + the
    audio tower frozen) on a toy tree, gradients from numpy, against optax."""
    kw = dict(optimizer_name=opt, betas=(0.9, 0.98), eps=1e-8, momentum=0.8,
              weight_decay=0.05 if opt == "adamw" else 0.0)
    config = {"audio_encoder_args": {"freeze": freeze}, "text_encoder_args": {}}

    def build(mod, chain_fn, clip_fn, freeze_fn):
        o = mod.get_optimizer(mod.cosine_lr(0.1, 1, 4), **kw)
        if clip:
            o = chain_fn(clip_fn(clip), o)
        return freeze_fn(o, config)

    from zs_aac_tpu.train.pretrain import apply_freeze as jax_freeze

    jo = build(jopt, optax.chain, optax.clip_by_global_norm, jax_freeze)
    to = build(topt, topt.chain, topt.clip_by_global_norm, apply_freeze)
    jp = jax.tree.map(jnp.asarray, _toy_tree(0))
    tp = _to_torch(_toy_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: x * (3.0 if i == 1 else 0.5), _toy_tree(10 + i))
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    want, got = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    if freeze:
        np.testing.assert_array_equal(got["audio_enc/w"], _toy_tree(0)["audio_enc"]["w"])


def jax_train_run(steps=testdata.TRAIN_STEPS):
    """The JAX package's ``make_ase_train_step`` (``mel_impl="xla"``) on the
    tiny ASE, with the recorded optimizer: (losses, params, batch_stats) as
    numpy."""
    from zs_aac_tpu.models.convert import convert_ase
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.train.contrastive import ASETrainState, make_ase_train_step

    saved = dict(jase.TEXT_MODEL_REGISTRY)
    register_tiny_bert_in_jax(dict.__setitem__)
    try:
        cfg = jase.ASEConfig(**ase_config_kwargs())
        sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
        variables = jax.tree.map(jnp.asarray, convert_ase(sd, cfg))
        o = testdata.TRAIN_OPTIM
        opt = optax.chain(optax.clip_by_global_norm(o["clip"]),
                          jopt.get_optimizer(jopt.cosine_lr(o["lr"], o["warmup"], steps),
                                             o["optimizer"]))
        config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
        step = make_ase_train_step(jase.ASE(cfg), opt, LogMelConfig.from_dict(
            config["audio_args"]), mel_impl="xla")
        state = ASETrainState(variables["params"], variables["batch_stats"],
                              opt.init(variables["params"]), jnp.zeros((), jnp.int32))
        batch = {k: jnp.asarray(v) for k, v in testdata.train_batch().items()}
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch, jax.random.key(0))
            losses.append(float(loss))
        as_np = lambda t: jax.tree.map(np.asarray, t)
        return losses, as_np(state.params), as_np(state.batch_stats)
    finally:
        jase.TEXT_MODEL_REGISTRY.clear()
        jase.TEXT_MODEL_REGISTRY.update(saved)


def _record(losses, params, stats):
    bn = stats["audio_enc"]["bn0"]
    return {"losses": losses, "checksums": testdata.checksums(params),
            "batch_stats": {k: np.asarray(v).tolist() for k, v in bn.items()}}


@pytest.fixture(scope="module")
def jax_run():
    return jax_train_run()


def test_train_step_matches_jax(jax_run):
    """Three steps of the port's ``make_ase_train_step`` on the CPU against
    the JAX package's, leaf by leaf."""
    from zs_aac_tpu_torch.models.convert import convert_ase
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    losses, params, stats = jax_run
    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    ase, cfg = build_ase_from_config(config, device="cpu")
    sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    opt = testdata.train_optimizer()
    state = create_ase_state(0, ase, opt, device="cpu",
                             variables=convert_ase(sd, cfg, device="cpu"))
    step = make_ase_train_step(ase, opt, LogMelConfig.from_dict(config["audio_args"]),
                               device="cpu")
    batch = testdata.train_batch()
    got = []
    for _ in range(testdata.TRAIN_STEPS):
        state, loss = step(state, batch, 0)
        got.append(loss.item())
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert got[-1] < got[0]
    want = _flat(params)
    mine = _flat({k: v for k, v in jax.tree.map(np.asarray, _np(state.params)).items()})
    assert sorted(mine) == sorted(want)
    for k in want:
        scale = np.abs(want[k]).max() + 1e-12
        np.testing.assert_allclose(mine[k], want[k], rtol=0, atol=1e-4 * scale, err_msg=k)
    for k in ("mean", "var"):
        np.testing.assert_allclose(state.batch_stats["audio_enc"]["bn0"][k].numpy(),
                                   stats["audio_enc"]["bn0"][k], rtol=1e-5, atol=1e-6)
    assert state.step == testdata.TRAIN_STEPS


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy() for k, v in tree.items()}


def test_train_fixture_reproduced():
    """The port replays the committed JAX-recorded run on the CPU."""
    want = json.loads(EXPECTED.read_text())
    got = testdata.replay_train_fixture(device="cpu")
    err = testdata.train_fixture_errors(got, want)
    assert err["loss"] < 1e-4 and err["params"] < 1e-4 and err["batch_stats"] < 1e-5, err


def test_fixture_records_a_moving_run():
    """The recorded checksums catch a wrong update: the run moved every
    trained leaf away from the checkpoint, and the losses fell."""
    want = json.loads(EXPECTED.read_text())
    from zs_aac_tpu_torch.models.convert import convert_ase
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    _, cfg = build_ase_from_config(config, device="cpu")
    sd = torch.load(testdata.TINY_ASE_DIR / "ase.pt", map_location="cpu", weights_only=True)
    start = testdata.checksums(_np(convert_ase(sd, cfg, device="cpu")["params"]))
    moved = [k for k in start if start[k] != want["checksums"][k]]
    assert len(moved) >= 0.9 * len(start)
    assert want["losses"][-1] < want["losses"][0]


if __name__ == "__main__" and "--write-fixture" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    rec = _record(*jax_train_run())
    EXPECTED.write_text(json.dumps(rec, indent=0, sort_keys=True) + "\n")
    print(f"wrote {EXPECTED} ({EXPECTED.stat().st_size} bytes), losses {rec['losses']}")
