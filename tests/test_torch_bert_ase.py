"""The port's BERT text tower and ASE encoders against the JAX package's,
on the same weights: a reference-layout CLAP state dict (the torch HTSAT
twin of ``tests/test_htsat.py`` plus a tiny BERT in HF ``BertModel`` layout
and the projection heads), read by both packages' converters.

Tolerances (fp32, summation order only): BERT hidden states 2e-5 at |h| ~ 3;
L2-normalized embeddings 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_htsat import TINY, TorchHTSAT, _randomize_torch_htsat
from zs_aac_tpu.models import ase as jase
from zs_aac_tpu.models import bert as jbert
from zs_aac_tpu.models.convert import convert_ase as jax_convert_ase
from zs_aac_tpu_torch.models import ase as tase
from zs_aac_tpu_torch.models import bert as tbert
from zs_aac_tpu_torch.models.convert import convert_ase, from_jax_params

torch.set_num_threads(2)

TEXT_MODEL = "bert-tiny-test"
EMBED = 32


def ase_config_kwargs():
    return dict(embed_size=EMBED, audio_encoder="htsat", text_model=TEXT_MODEL,
                spec_augmentation=False, htsat_kwargs=tuple(TINY.items()))


def register_tiny_bert_in_jax(setitem):
    """The JAX registry has no tiny-vocabulary BERT; give it the port's
    test geometry under the same name (``setitem(dict, key, value)``)."""
    setitem(jase.TEXT_MODEL_REGISTRY, TEXT_MODEL, tase.TEXT_MODEL_REGISTRY[TEXT_MODEL])


@pytest.fixture
def tiny_registry(monkeypatch):
    register_tiny_bert_in_jax(monkeypatch.setitem)


def reference_state_dict(seed=0) -> dict:
    """A CLAP checkpoint in the reference layout (``HTSAT-BERT-ZS.pt``): real
    random weights everywhere, LayerNorm scales and biases included."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    tm = TorchHTSAT()
    _randomize_torch_htsat(tm, rng)
    sd = {f"audio_encoder.audio_enc.{k}": v.clone() for k, v in tm.state_dict().items()}
    cfg = tbert.BertConfig(**tase.TEXT_MODEL_REGISTRY[TEXT_MODEL])
    H, I = cfg.hidden_size, cfg.intermediate_size

    def put(name, *shape, kind="w"):
        if kind == "w":
            a = rng.standard_normal(shape) * (0.5 / np.sqrt(shape[-1]))
        elif kind == "ln":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))

    t = "text_encoder.text_encoder."
    put(t + "embeddings.word_embeddings.weight", cfg.vocab_size, H)
    put(t + "embeddings.position_embeddings.weight", cfg.max_position_embeddings, H)
    put(t + "embeddings.token_type_embeddings.weight", cfg.type_vocab_size, H)
    put(t + "embeddings.LayerNorm.weight", H, kind="ln")
    put(t + "embeddings.LayerNorm.bias", H, kind="b")
    for i in range(cfg.num_hidden_layers):
        p = f"{t}encoder.layer.{i}."
        for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                  "attention.output.dense"):
            put(p + n + ".weight", H, H)
            put(p + n + ".bias", H, kind="b")
        put(p + "intermediate.dense.weight", I, H)
        put(p + "intermediate.dense.bias", I, kind="b")
        put(p + "output.dense.weight", H, I)
        put(p + "output.dense.bias", H, kind="b")
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            put(p + n + ".weight", H, kind="ln")
            put(p + n + ".bias", H, kind="b")
    put(t + "pooler.dense.weight", H, H)           # ignored by both converters
    for tower, din in (("audio_proj", tm.norm.normalized_shape[0]), ("text_proj", H)):
        put(f"{tower}.0.weight", EMBED, din)
        put(f"{tower}.0.bias", EMBED, kind="b")
        put(f"{tower}.2.weight", EMBED, EMBED)
        put(f"{tower}.2.bias", EMBED, kind="b")
    sd["temp"] = torch.tensor(0.07)
    return sd


def _text_inputs(B=3, L=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    return ids, mask


def test_bert_matches_jax():
    sd = reference_state_dict()
    text_sd = {k[len("text_encoder.text_encoder."):]: v for k, v in sd.items()
               if k.startswith("text_encoder.text_encoder.")}
    cfg_j = jbert.BertConfig(**tase.TEXT_MODEL_REGISTRY[TEXT_MODEL])
    cfg_t = tbert.BertConfig(**tase.TEXT_MODEL_REGISTRY[TEXT_MODEL])
    ids, mask = _text_inputs()
    want = np.asarray(jbert.BertEncoder(cfg_j).apply(
        jbert.convert_bert(text_sd, cfg_j), jnp.asarray(ids), jnp.asarray(mask)))
    params = tbert.convert_bert({"bert." + k: v for k, v in text_sd.items()}, cfg_t,
                                device="cpu")["params"]
    got = tbert.BertEncoder(cfg_t).apply(params, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # no mask = all kept
    full = tbert.BertEncoder(cfg_t).apply(params, torch.from_numpy(ids))
    want_full = np.asarray(jbert.BertEncoder(cfg_j).apply(
        jbert.convert_bert(text_sd, cfg_j), jnp.asarray(ids)))
    np.testing.assert_allclose(full.numpy(), want_full, rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def ase_pair():
    sd = reference_state_dict(seed=1)
    saved = dict(jase.TEXT_MODEL_REGISTRY)
    register_tiny_bert_in_jax(dict.__setitem__)
    try:
        cfg_j = jase.ASEConfig(**ase_config_kwargs())
        jvars = jax.tree.map(jnp.asarray, jax_convert_ase(sd, cfg_j))
        rng = np.random.default_rng(3)
        spec = rng.standard_normal((3, 101, 16)).astype(np.float32)
        ids, mask = _text_inputs(seed=4)
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
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ase_encoders_match_jax(ase_pair, route, fused):
    cfg = tase.ASEConfig(**ase_config_kwargs(), fused_attn=fused, fused_block=(0,) if fused
                         else False)
    variables = (convert_ase(ase_pair["sd"], cfg, device="cpu") if route == "convert_ase"
                 else from_jax_params(ase_pair["jvars"], device="cpu"))
    model = tase.ASE(cfg)
    a = model.encode_audio(variables, torch.from_numpy(ase_pair["spec"]))
    t = model.encode_text(variables, torch.from_numpy(ase_pair["ids"]),
                          torch.from_numpy(ase_pair["mask"]))
    np.testing.assert_allclose(a.numpy(), ase_pair["want_a"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), ase_pair["want_t"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(a.numpy(), axis=1), 1.0, rtol=1e-5)


def test_convert_ase_tree_matches_jax(ase_pair):
    got = convert_ase(ase_pair["sd"], tase.ASEConfig(**ase_config_kwargs()), device="cpu")
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    got_f = flat(jax.tree.map(lambda t: t.numpy(), got))
    want_f = flat(ase_pair["jvars"])
    assert set(got_f) == set(want_f)
    for k, v in want_f.items():
        np.testing.assert_array_equal(got_f[k], v, err_msg=k)


def test_init_ase_tree_matches_jax_init(tiny_registry):
    cfg_j = jase.ASEConfig(**ase_config_kwargs())
    ref = jax.jit(lambda r: jase.ASE(cfg_j).init(
        {"params": r}, jnp.zeros((1, 101, 16)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False))(jax.random.key(0))
    got = tase.init_ase(tase.ASEConfig(**ase_config_kwargs()), seed=0, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(jax.tree.map(lambda t: t.numpy(), got)) == shapes(ref)


def test_registry_matches_jax():
    for name, kw in jase.TEXT_MODEL_REGISTRY.items():
        assert tase.TEXT_MODEL_REGISTRY[name] == kw
        assert dataclasses_equal(tase.text_config(name), jase.text_config(name))


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
