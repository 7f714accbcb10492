"""The port's ASE with the PANNs audio towers against the JAX package's: the
init tree, the encoders on a reference-layout CLAP checkpoint with a Cnn14
tower (``convert_ase`` and ``from_jax_params``), a 3-step contrastive train
run, and the committed ``tiny_clap`` checkpoint's audio embeddings.

JAX's ``ASE`` builds its Cnn14 at dropout 0.2 with no config field, and so
does the port's: the train run sets dropout to 0 on both sides by replacing
each package's ``Cnn14`` with a subclass at ``dropout_rate = 0.0`` inside the
test process.

Tolerances (fp32, summation order only): L2-normalized embeddings 1e-5; the
train run as ``tests/test_torch_train_step.py`` holds HTSAT's: losses 1e-4
relative, batch statistics 1e-5 relative and 1e-6 absolute, and the updated
parameters by their per-leaf checksums within 1e-4 (``train_fixture_errors``,
the bound of the recorded HTSAT run). The gradients agree to ~5e-5 of each
leaf's largest entry; Adam divides each entry by its own running scale, so an
entry whose gradient is near zero moves by a sizeable share of the learning
rate on noise alone (one entry of a text-tower kernel lands 4e-5 from JAX,
twice 1e-4 of its leaf's largest), which a per-entry bound would read as a
fault; the checksums (sums, absolute sums, squares and a ramp-weighted sum
per leaf, the next worst leaf at 1.5e-5) still catch a wrong or misplaced
update. The attention key biases, whose gradient is 0 in exact arithmetic (a
query's softmax ignores a shift common to all its keys), take Adam steps on
rounding noise in both packages: each is held to within ``steps * lr`` of
its start instead. The committed record against JAX now: 1e-6.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_cnns import _TorchMiniCnn
from test_torch_bert_ase import (reference_state_dict, register_tiny_bert_in_jax,  # noqa: F401
                                 tiny_registry)
from test_torch_cnns import _randomize_torch
from test_torch_magic import CLAP_AUDIO_RECORD, jax_clap_audio_embeddings
from zs_aac_tpu.models import ase as jase
from zs_aac_tpu.models import cnns as jcnns
from zs_aac_tpu.models.convert import convert_ase as jax_convert_ase
from zs_aac_tpu.train import optim as jopt
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.models import ase as tase
from zs_aac_tpu_torch.models import cnns as tcnns
from zs_aac_tpu_torch.models.convert import convert_ase, from_jax_params

torch.set_num_threads(2)

EMBED = 32
CHANNELS = (4, 8)
N_MELS = 16


def cnn_ase_kwargs(**kw):
    return dict(embed_size=EMBED, audio_encoder="cnn14", audio_channels=CHANNELS,
                text_model="bert-tiny-test", spec_augmentation=False, **kw)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _np(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("tower", ["cnn14", "resnet38"])
def test_init_ase_tree_matches_jax_init(tower, tiny_registry):
    kw = dict(embed_size=EMBED, audio_encoder=tower, text_model="bert-tiny-test",
              spec_augmentation=False, audio_channels=CHANNELS if tower == "cnn14" else None)
    ref = jax.eval_shape(lambda r: jase.ASE(jase.ASEConfig(**kw)).init(
        {"params": r}, jnp.zeros((1, 101, N_MELS * 4)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False), jax.random.key(0))
    got = tase.init_ase(tase.ASEConfig(n_mels=N_MELS * 4, **kw), seed=0, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(v.shape)
                           for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(_np(got)) == shapes(ref)


def cnn_reference_state_dict(seed=0) -> dict:
    """A CLAP checkpoint in the reference layout with a Cnn14 tower of
    ``CHANNELS`` over ``N_MELS`` mels (the torch twin of ``tests/test_cnns.py``,
    BN statistics randomized) and ``reference_state_dict``'s text tower."""
    torch.manual_seed(seed)
    cnn = _TorchMiniCnn(CHANNELS)
    _randomize_torch(cnn, seed + 1)
    sd = {k: v for k, v in reference_state_dict(seed).items()
          if not k.startswith(("audio_encoder.", "audio_proj."))}
    sd.update({f"audio_encoder.audio_enc.{k}": v.clone() for k, v in cnn.state_dict().items()})
    sd["audio_encoder.audio_enc.fc1.weight"] = torch.zeros(4, 4)       # skipped
    rng = np.random.default_rng(seed + 2)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32))
    sd.update({"audio_proj.0.weight": f(EMBED, CHANNELS[-1]), "audio_proj.0.bias": f(EMBED),
               "audio_proj.2.weight": f(EMBED, EMBED), "audio_proj.2.bias": f(EMBED)})
    return sd


@pytest.fixture(scope="module")
def cnn_pair():
    sd = cnn_reference_state_dict(seed=1)
    saved = dict(jase.TEXT_MODEL_REGISTRY)
    register_tiny_bert_in_jax(dict.__setitem__)
    try:
        cfg_j = jase.ASEConfig(**cnn_ase_kwargs())
        jvars = jax.tree.map(jnp.asarray, jax_convert_ase(sd, cfg_j))
        rng = np.random.default_rng(3)
        spec = rng.standard_normal((3, 101, N_MELS)).astype(np.float32) * 3
        ids = rng.integers(0, 64, (3, 9)).astype(np.int32)
        mask = np.ones((3, 9), np.int32)
        mask[1, 5:] = 0
        model = jase.ASE(cfg_j)
        want_a = np.asarray(model.apply(jvars, jnp.asarray(spec), method=jase.ASE.encode_audio))
        want_t = np.asarray(model.apply(jvars, jnp.asarray(ids), jnp.asarray(mask),
                                        method=jase.ASE.encode_text))
    finally:
        jase.TEXT_MODEL_REGISTRY.clear()
        jase.TEXT_MODEL_REGISTRY.update(saved)
    return dict(sd=sd, jvars=jax.tree.map(np.asarray, jvars), spec=spec, ids=ids, mask=mask,
                want_a=want_a, want_t=want_t)


@pytest.mark.parametrize("route", ["convert_ase", "from_jax_params"])
def test_cnn_ase_encoders_match_jax(cnn_pair, route):
    cfg = tase.ASEConfig(n_mels=N_MELS, **cnn_ase_kwargs())
    variables = (convert_ase(cnn_pair["sd"], cfg, device="cpu") if route == "convert_ase"
                 else from_jax_params(cnn_pair["jvars"], device="cpu"))
    model = tase.ASE(cfg)
    a = model.encode_audio(variables, torch.from_numpy(cnn_pair["spec"]))
    t = model.encode_text(variables, torch.from_numpy(cnn_pair["ids"]),
                          torch.from_numpy(cnn_pair["mask"]))
    np.testing.assert_allclose(a.numpy(), cnn_pair["want_a"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), cnn_pair["want_t"], rtol=1e-5, atol=1e-5)


def test_convert_ase_cnn_tree_matches_jax(cnn_pair):
    got = _flat(_np(convert_ase(cnn_pair["sd"], tase.ASEConfig(**cnn_ase_kwargs()),
                                device="cpu")))
    want = _flat(cnn_pair["jvars"])
    assert sorted(got) == sorted(want)
    assert len([k for k in want if "batch_stats" in k]) == 2 * (1 + 2 * len(CHANNELS))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# --- a 3-step contrastive train run ------------------------------------------


def _no_dropout(monkeypatch):
    """Cnn14 at dropout 0 in both packages' ASE (neither config has the field)."""
    class JaxCnn14(jcnns.Cnn14):
        dropout_rate: float = 0.0

    @dataclasses.dataclass(frozen=True)
    class TorchCnn14(tcnns.Cnn14):
        dropout_rate: float = 0.0

    monkeypatch.setattr(jcnns, "Cnn14", JaxCnn14)
    monkeypatch.setattr(tase, "Cnn14", TorchCnn14)


def _train_config():
    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14"}
    config["audio_channels"] = list(CHANNELS)
    return config


def test_cnn_train_step_matches_jax(monkeypatch, tiny_registry):
    """Three steps of the port's ``make_ase_train_step`` on a tiny Cnn14 +
    tiny BERT ASE against the JAX package's (``mel_impl="xla"``): the tiny
    ASE fixture's batch (1 s clips, 16 mels) and optimizer, weights from
    ``cnn_reference_state_dict``."""
    from zs_aac_tpu.ops.logmel import LogMelConfig as JaxMel
    from zs_aac_tpu.train.contrastive import ASETrainState, make_ase_train_step as jax_step
    from zs_aac_tpu.train.pretrain import build_ase_from_config as jax_build
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step
    from zs_aac_tpu_torch.train.pretrain import build_ase_from_config

    _no_dropout(monkeypatch)
    config = _train_config()
    sd = cnn_reference_state_dict(seed=4)
    batch = testdata.train_batch()
    steps, o = testdata.TRAIN_STEPS, testdata.TRAIN_OPTIM

    jase_, jcfg = jax_build(config)
    jvars = jax.tree.map(jnp.asarray, jax_convert_ase(sd, jcfg))
    opt = optax.chain(optax.clip_by_global_norm(o["clip"]),
                      jopt.get_optimizer(jopt.cosine_lr(o["lr"], o["warmup"], steps),
                                         o["optimizer"]))
    step = jax_step(jase_, opt, JaxMel.from_dict(config["audio_args"]), mel_impl="xla")
    state = ASETrainState(jvars["params"], jvars["batch_stats"], opt.init(jvars["params"]),
                          jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_losses = []
    for _ in range(steps):
        state, loss = step(state, jb, jax.random.key(0))
        want_losses.append(float(loss))

    ase, cfg = build_ase_from_config(config, device="cpu")
    assert ase.audio_enc.dropout_rate == 0.0 and cfg.n_mels == N_MELS
    topt = testdata.train_optimizer()
    tstate = create_ase_state(0, ase, topt, device="cpu",
                              variables=convert_ase(sd, cfg, device="cpu"))
    tstep = make_ase_train_step(ase, topt, LogMelConfig.from_dict(config["audio_args"]),
                                device="cpu")
    got_losses = []
    for _ in range(steps):
        tstate, loss = tstep(tstate, batch, 0)
        got_losses.append(loss.item())
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]
    want, mine = _flat(jax.tree.map(np.asarray, state.params)), _flat(_np(tstate.params))
    assert sorted(mine) == sorted(want)
    start = _flat(_np(convert_ase(sd, cfg, device="cpu")["params"]))
    key_bias = [k for k in want if k.endswith("['key']['bias']")]
    assert len(key_bias) == 2
    for k in key_bias:   # gradient 0 in exact arithmetic: Adam steps on rounding noise
        assert np.abs(mine[k] - start[k]).max() <= steps * o["lr"] * 1.01, k
        assert np.abs(want[k] - start[k]).max() <= steps * o["lr"] * 1.01, k
    rest = lambda tree: {k: v for k, v in tree.items() if k not in key_bias}
    err = testdata.train_fixture_errors(
        {"losses": got_losses, "checksums": testdata.checksums(rest(mine)), "batch_stats": {}},
        {"losses": want_losses, "checksums": testdata.checksums(rest(want)), "batch_stats": {}})
    assert err["params"] < 1e-4, err
    want_s = _flat(jax.tree.map(np.asarray, state.batch_stats))
    mine_s = _flat(_np(tstate.batch_stats))
    assert sorted(mine_s) == sorted(want_s) and len(want_s) == 2 * (1 + 2 * len(CHANNELS))
    for k in want_s:
        np.testing.assert_allclose(mine_s[k], want_s[k], rtol=1e-5, atol=1e-6, err_msg=k)


# --- the committed tiny CLAP checkpoint -------------------------------------


def _clap_encode(device="cpu"):
    """The port's eval-mode audio encoder on ``tiny_clap/ase.msgpack``."""
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import make_encode_fns
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    meta = json.loads((testdata.TINY_CLAP_DIR / "ase.msgpack.json").read_text())
    cfg = tase.ASEConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in meta["ase_config"].items()})
    variables = from_jax_params(load_params(str(testdata.TINY_CLAP_DIR / "ase.msgpack")),
                                device=device)
    enc_a, _ = make_encode_fns(tase.ASE(cfg), LogMelConfig(), device=device)
    return lambda waves: enc_a(variables, torch.from_numpy(waves)).numpy()


def test_tiny_clap_audio_record_is_what_jax_computes(tiny_registry):
    want = np.asarray(json.loads(CLAP_AUDIO_RECORD.read_text())["audio_embeddings"], np.float32)
    np.testing.assert_allclose(jax_clap_audio_embeddings(), want, rtol=0, atol=1e-6)
    assert want.shape == (3, EMBED)
    # three distinct embeddings, far apart on the scale of the port's tolerance
    assert min(np.abs(want[i] - want[j]).max() for i, j in ((0, 1), (1, 2), (0, 2))) > 1e-3


def test_tiny_clap_cnn14_tower_matches_the_jax_record():
    want = np.asarray(json.loads(CLAP_AUDIO_RECORD.read_text())["audio_embeddings"], np.float32)
    got = _clap_encode()(testdata.clap_waves())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
