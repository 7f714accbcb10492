"""The port's CLIP and GPT-2 text towers against the JAX package's.

- The towers' full hidden states ``[B, L, D]`` on ids whose first token
  varies (so position 0 differs between rows) and padded rows, fp32 and
  bf16, from one seeded HF-layout numpy state dict (``GPT2LMHeadModel`` and
  ``CLIPTextModel`` keys, built without ``transformers``) read by both
  packages' converters; the converted trees equal bitwise.
- ``gelu_new`` is ``F.gelu(approximate="tanh")`` up to rounding.
- The ASE with each tiny tower from the JAX init: its loss and the gradient
  of every parameter leaf; a 2-step train run against JAX's train step
  (every updated entry within 1e-3 of the steps' reach, ``steps * lr``); the
  pretrain driver with a GPT-2 tower; the extract driver's bank against the
  JAX package's.
- Under these causal towers the ASE's text embedding is the same for every
  caption, in both packages: WordPiece puts ``[CLS]`` at position 0 of every
  row and the ASE takes position 0.
- The committed ``tiny_text_towers`` record (hidden states, embeddings, the
  JAX package's float MAGIC captions with each tower) and ``--q8_tower``
  refused for these towers in both packages.

Tolerances: fp32 hidden states and embeddings 2e-5 absolute at |h| ~ 3 (the
BERT tests'; summation order only); the loss 1e-6 relative and each
gradient leaf within 1e-5 of its largest entry. bf16: each package rounds at
other points (PyTorch's softmax and GELU compute in fp32 and round once, the
JAX ones in bf16 throughout), so the two bf16 towers are held to each other
within twice the larger of the two bf16 towers' own distance from the fp32
tower (the size of bf16 noise on this input), and at most 2^-4 of the
largest |h|.
"""

import functools
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zs_aac_tpu.models import ase as jase
from zs_aac_tpu.models import text_towers as jtt
from zs_aac_tpu_torch import testdata
from zs_aac_tpu_torch.models import ase as tase
from zs_aac_tpu_torch.models import text_towers as ttt
from zs_aac_tpu_torch.models.convert import convert_ase, from_jax_params

torch.set_num_threads(2)

TOL = 2e-5
EMBED = 32
CHANNELS = (4, 8)
GPT2 = ttt.GPT2EncoderConfig(**tase.GPT2_TEXT_REGISTRY["gpt2-tiny"])
CLIP = ttt.CLIPTextConfig(**tase.CLIP_TEXT_REGISTRY["clip-tiny"])
CFGS = {"gpt2-tiny": (GPT2, jtt.GPT2EncoderConfig(**jase.GPT2_TEXT_REGISTRY["gpt2-tiny"])),
        "clip-tiny": (CLIP, jtt.CLIPTextConfig(**jase.CLIP_TEXT_REGISTRY["clip-tiny"]))}


def hf_gpt2_state_dict(cfg, seed=0) -> dict:
    """A ``GPT2LMHeadModel`` state dict (numpy): Conv1D weights [in, out],
    HF's causal-mask buffers and the LM head, which the converters skip."""
    rng = np.random.default_rng(seed)
    D, P = cfg.n_embd, cfg.n_positions
    f = lambda *s, scale=None: (rng.standard_normal(s) * (scale or s[0] ** -0.5)).astype(np.float32)
    ln = lambda: {"weight": 1 + 0.2 * f(D, scale=1), "bias": 0.1 * f(D, scale=1)}
    sd = {"transformer.wte.weight": f(cfg.vocab_size, D, scale=0.5),
          "transformer.wpe.weight": f(P, D, scale=0.5), "lm_head.weight": f(cfg.vocab_size, D)}
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        for name, (din, dout) in (("attn.c_attn", (D, 3 * D)), ("attn.c_proj", (D, D)),
                                  ("mlp.c_fc", (D, 4 * D)), ("mlp.c_proj", (4 * D, D))):
            sd[p + name + ".weight"] = f(din, dout)
            sd[p + name + ".bias"] = 0.1 * f(dout, scale=1)
        for name in ("ln_1", "ln_2"):
            for k, v in ln().items():
                sd[f"{p}{name}.{k}"] = v
        sd[p + "attn.bias"] = np.tril(np.ones((P, P), np.float32))[None, None]
    for k, v in ln().items():
        sd[f"transformer.ln_f.{k}"] = v
    return sd


def hf_clip_state_dict(cfg, seed=0) -> dict:
    """A ``CLIPTextModel`` state dict (numpy): Linear weights [out, in] and
    the ``position_ids`` buffer."""
    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    f = lambda *s, scale=None: (rng.standard_normal(s) * (scale or s[-1] ** -0.5)).astype(np.float32)
    t = "text_model."
    sd = {t + "embeddings.token_embedding.weight": f(cfg.vocab_size, D, scale=0.5),
          t + "embeddings.position_embedding.weight": f(cfg.max_positions, D, scale=0.5),
          t + "embeddings.position_ids": np.arange(cfg.max_positions)[None]}
    for i in range(cfg.n_layer):
        p = f"{t}encoder.layers.{i}."
        for name, (dout, din) in (("self_attn.q_proj", (D, D)), ("self_attn.k_proj", (D, D)),
                                  ("self_attn.v_proj", (D, D)), ("self_attn.out_proj", (D, D)),
                                  ("mlp.fc1", (I, D)), ("mlp.fc2", (D, I))):
            sd[p + name + ".weight"] = f(dout, din)
            sd[p + name + ".bias"] = 0.1 * f(dout, scale=1)
        for name in ("layer_norm1", "layer_norm2"):
            sd[f"{p}{name}.weight"] = 1 + 0.2 * f(D, scale=1)
            sd[f"{p}{name}.bias"] = 0.1 * f(D, scale=1)
    sd[t + "final_layer_norm.weight"] = 1 + 0.2 * f(D, scale=1)
    sd[t + "final_layer_norm.bias"] = 0.1 * f(D, scale=1)
    return sd


def tower_ids(vocab, B=4, L=8, seed=0):
    """Ids whose first token differs between rows, and a mask with two
    padded rows (one padded to a single token)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, L)).astype(np.int32)
    ids[:, 0] = np.arange(B) * 3 + 2
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    mask[3, 1:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _pair(name, dtype_j=jnp.float32, dtype_t=torch.float32, seed=0):
    if name == "gpt2-tiny":
        sd = hf_gpt2_state_dict(GPT2, seed)
        jv = jtt.convert_gpt2_encoder(sd, CFGS[name][1])
        tv = ttt.convert_gpt2_encoder(sd, GPT2, device="cpu")
        return (jtt.GPT2TextEncoder(CFGS[name][1], dtype_j), jv,
                ttt.GPT2TextEncoder(GPT2, dtype_t), tv, sd)
    sd = hf_clip_state_dict(CLIP, seed)
    jv = jtt.convert_clip_text(sd, CFGS[name][1])
    tv = ttt.convert_clip_text(sd, CLIP, device="cpu")
    return (jtt.CLIPTextEncoder(CFGS[name][1], dtype_j), jv,
            ttt.CLIPTextEncoder(CLIP, dtype_t), tv, sd)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _np(tree):
    return jax.tree.map(lambda t: t.detach().float().numpy(), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_converters_read_the_hf_layout_as_jax(name):
    _, jv, _, tv, sd = _pair(name)
    want, got = _flat(jv), _flat(_np(tv))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the prefixes are optional, as the JAX converters strip them
    prefix = "transformer." if name == "gpt2-tiny" else "text_model."
    bare = {k.removeprefix(prefix): v for k, v in sd.items()}
    conv = ttt.convert_gpt2_encoder if name == "gpt2-tiny" else ttt.convert_clip_text
    again = _flat(_np(conv(bare, CFGS[name][0], device="cpu")))
    assert all(np.array_equal(again[k], v) for k, v in got.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_hidden_states_match_jax(name, dtype):
    ids, mask = tower_ids(CFGS[name][0].vocab_size)
    jm32, jv, tm32, tv, _ = _pair(name)
    want32 = np.asarray(jm32.apply(jv, jnp.asarray(ids), jnp.asarray(mask)))
    got32 = tm32.apply(tv["params"], torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got32.shape == (4, 8, EMBED) and np.abs(want32).max() > 1
    # position 0 differs between rows: the hidden states are not trivially equal
    assert np.abs(want32[0, 0] - want32[2, 0]).max() > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got32, want32, rtol=0, atol=TOL)
        return
    jm, _, tm, _, _ = _pair(name, jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jm.apply(jv, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))
    got = tm.apply(tv["params"], torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    scale = np.abs(want32).max()
    noise = max(np.abs(want - want32).max(), np.abs(got - want32).max())
    bound = min(2 * noise, 2.0 ** -4 * scale)
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), noise, scale)


def test_gelu_new_is_the_tanh_gelu():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jtt._gelu_new(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = np.asarray(jtt._gelu_new(xb).astype(jnp.float32))
    gb = torch.nn.functional.gelu(torch.from_numpy(x).bfloat16(), approximate="tanh").float()
    # within two bf16 steps of the value (the JAX formula rounds at each op)
    assert np.all(np.abs(gb.numpy() - wb) <= 2 * 2.0 ** -8 * np.maximum(np.abs(wb), 1))


def test_registries_match_jax():
    assert tase.CLIP_TEXT_REGISTRY == jase.CLIP_TEXT_REGISTRY
    assert tase.GPT2_TEXT_REGISTRY == jase.GPT2_TEXT_REGISTRY
    for name in ("gpt2", "openai/clip-vit-base-patch32"):
        with pytest.raises(KeyError):
            jase.text_config(name)
        with pytest.raises(KeyError):
            tase.text_config(name)
    for name in ("gpt2", "distilgpt2", "openai/clip-vit-base-patch32"):
        ase = tase.ASE(tase.ASEConfig(audio_encoder="htsat", text_model=name))
        width = ase.text_enc.cfg.n_embd if "gpt2" in name else ase.text_enc.cfg.hidden_size
        assert width == (512 if "clip" in name else 768)
    assert tase.ASE(tase.ASEConfig(text_model="distilgpt2")).text_enc.cfg.n_layer == 6


# --- the ASE over the tiny towers, from the JAX init ----------------------------


def ase_kwargs(name):
    return dict(embed_size=EMBED, audio_encoder="cnn14", audio_channels=CHANNELS,
                text_model=name, spec_augmentation=False)


@functools.lru_cache(maxsize=None)
def jax_init(name, seed=0):
    cfg = jase.ASEConfig(**ase_kwargs(name))
    v = jax.jit(lambda r: jase.ASE(cfg).init(
        {"params": r}, jnp.zeros((1, 64, 64)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False))(jax.random.key(seed))
    return cfg, jax.tree.map(np.asarray, v)


def jax_variables(name):
    """The JAX package's init of the tiny ASE with ``name``'s tower as the
    fixture's writer saved it (``jax_init`` at seed 10 or 11), read without
    compiling an init."""
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    return (jase.ASEConfig(**ase_kwargs(name)),
            load_params(str(testdata.TINY_TEXT_TOWERS_DIR / f"{name}.msgpack")))


@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_init_ase_tree_matches_jax_init(name):
    cfg = jase.ASEConfig(**ase_kwargs(name))
    ref = jax.eval_shape(lambda r: jase.ASE(cfg).init(
        {"params": r}, jnp.zeros((1, 64, 64)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False), jax.random.key(0))
    got = tase.init_ase(tase.ASEConfig(**ase_kwargs(name)), seed=0, device="cpu")
    assert _shapes(_np(got)) == _shapes(ref)
    # flax's initializers: LeCun-normal kernels truncated at 2 sigma, embeddings
    # with variance 1/features, LayerNorm ones
    text = got["params"]["text_enc"]
    emb = text["wte" if name == "gpt2-tiny" else "token_embedding"]["embedding"]
    assert abs(emb.std().item() * EMBED ** 0.5 - 1) < 0.1
    k = text["h0" if name == "gpt2-tiny" else "layer0"]["c_fc" if name == "gpt2-tiny"
                                                        else "fc1"]["kernel"]
    assert abs(k.std().item() * EMBED ** 0.5 - 1) < 0.1
    assert k.abs().max().item() * EMBED ** 0.5 <= 2 / 0.87962566 + 1e-4


def _loss_and_grads_jax(cfg, v, spec, ids, mask, idx):
    def loss(params):
        return jase.ASE(cfg).apply({"params": params, "batch_stats": v["batch_stats"]},
                                   spec, ids, mask, idx, train=False)

    value, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, v["params"]))
    return float(value), _flat(grads)


@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_ase_loss_and_gradients_match_jax(name):
    from zs_aac_tpu_torch.train.optim import tree_leaves

    cfg_j, v = jax_variables(name)
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((4, 101, 64)).astype(np.float32) * 3
    ids, mask = tower_ids(CFGS[name][0].vocab_size, seed=3)
    idx = np.array([0, 0, 1, 2], np.int32)
    want_loss, want = _loss_and_grads_jax(cfg_j, v, jnp.asarray(spec), jnp.asarray(ids),
                                          jnp.asarray(mask), jnp.asarray(idx))

    ase = tase.ASE(tase.ASEConfig(**ase_kwargs(name)))
    tv = from_jax_params(v, device="cpu")
    params = jax.tree.map(lambda t: t.requires_grad_(True), tv["params"],
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    loss, _ = ase({"params": params, "batch_stats": tv["batch_stats"]}, torch.from_numpy(spec),
                  torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(idx),
                  train=False)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-6)
    got = _flat(_np({"g": jax.tree.unflatten(jax.tree.structure(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor)),
        [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)])})["g"])
    assert sorted(got) == sorted(want)
    text = [k for k in want if k.startswith("['text_enc']")]
    assert max(np.abs(want[k]).max() for k in text) > 1e-4      # the tower learns
    for k, w in want.items():
        # the text side entry by entry; the audio tower's leaves by cosine
        # and norm: a BatchNorm's bias sums the cotangent over every position
        # behind a ReLU, where outputs within rounding of 0 can switch their
        # gradient on or off between the packages (at these weights: 2.5e-5
        # of the leaf's largest entry and of its norm, every other audio leaf
        # < 1.2e-5; 2e-4 and 1.5e-4 at another JAX init)
        if k in text or k.startswith(("['text_proj']", "['temp']")):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 * np.abs(w).max() + 1e-9,
                                       err_msg=k)
        else:
            g, w = got[k].ravel().astype(np.float64), w.ravel().astype(np.float64)
            assert abs(np.linalg.norm(g) / np.linalg.norm(w) - 1) < 1e-3, k
            assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) > 1 - 1e-6, k


@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_text_embedding_is_the_same_for_every_caption_in_both_packages(name):
    """WordPiece puts [CLS] first; a causal tower's position 0 sees only it;
    the ASE takes position 0: every caption gets one embedding."""
    from zs_aac_tpu_torch.data.bert_tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_file(str(testdata.TINY_CLAP_DIR / "vocab.txt"))
    ids, mask = tok.batch_encode(["a dog barks", "rain falls on the roof", "the car ."],
                                 max_length=30, pad_to_max=True)
    assert len(set(map(tuple, ids[:, :4].tolist()))) == 3 and (ids[:, 0] == ids[0, 0]).all()
    cfg_j, v = jax_variables(name)
    encode = jax.jit(lambda v, i, m: jase.ASE(cfg_j).apply(v, i, m, method=jase.ASE.encode_text))
    want = np.asarray(encode(v, jnp.asarray(ids), jnp.asarray(mask)))
    got = tase.ASE(tase.ASEConfig(**ase_kwargs(name))).encode_text(
        from_jax_params(v, device="cpu"), torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for emb in (want, got):
        assert np.abs(emb - emb[0]).max() < 1e-6


# --- the drivers ------------------------------------------------------------------


def test_train_steps_match_jax(monkeypatch):
    """Two steps of the port's ``make_ase_train_step`` with the GPT-2 tower
    from the JAX init against the JAX package's, on the tiny ASE fixture's
    batch (its captions WordPiece-tokenized: [CLS] first) and optimizer,
    Cnn14 at dropout 0 (the CLIP tower's gradients are held above)."""
    import optax
    from test_torch_cnn_ase import _no_dropout
    from zs_aac_tpu.ops.logmel import LogMelConfig as JaxMel
    from zs_aac_tpu.train import optim as jopt
    from zs_aac_tpu.train.contrastive import ASETrainState, make_ase_train_step as jax_step
    from zs_aac_tpu_torch.ops.logmel import LogMelConfig
    from zs_aac_tpu_torch.train.contrastive import create_ase_state, make_ase_train_step

    _no_dropout(monkeypatch)
    name = "gpt2-tiny"
    config = json.loads((testdata.TINY_ASE_DIR / "config.json").read_text())
    batch = testdata.train_batch()
    steps, o = 2, testdata.TRAIN_OPTIM
    cfg_j = jase.ASEConfig(**ase_kwargs(name))
    v = jax.jit(lambda r: jase.ASE(cfg_j).init(
        {"params": r}, jnp.zeros((1, 101, 16)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False))(jax.random.key(5))
    v = jax.tree.map(np.asarray, v)
    opt = optax.chain(optax.clip_by_global_norm(o["clip"]),
                      jopt.get_optimizer(jopt.cosine_lr(o["lr"], o["warmup"], steps),
                                         o["optimizer"]))
    mel = config["audio_args"]
    step = jax_step(jase.ASE(cfg_j), opt, JaxMel.from_dict(mel), mel_impl="xla")
    state = ASETrainState(jax.tree.map(jnp.asarray, v["params"]),
                          jax.tree.map(jnp.asarray, v["batch_stats"]),
                          opt.init(v["params"]), jnp.zeros((), jnp.int32))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    want = []
    for _ in range(steps):
        state, loss = step(state, jb, jax.random.key(0))
        want.append(float(loss))

    from zs_aac_tpu_torch.train.optim import chain, clip_by_global_norm, cosine_lr, get_optimizer

    topt = chain(clip_by_global_norm(o["clip"]),
                 get_optimizer(cosine_lr(o["lr"], o["warmup"], steps), o["optimizer"]))
    ase = tase.ASE(tase.ASEConfig(n_mels=16, **ase_kwargs(name)))
    tstate = create_ase_state(0, ase, topt, device="cpu", variables=from_jax_params(v, "cpu"))
    tstep = make_ase_train_step(ase, topt, LogMelConfig.from_dict(mel), device="cpu")
    got = []
    for _ in range(steps):
        tstate, loss = tstep(tstate, batch, 0)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Adam moves each entry by about lr a step whatever its gradient's size,
    # so an entry whose gradient is near 0 moves by a share of lr on rounding
    # noise (one entry of 4096 of a tower's MLP kernel parts by 2e-6). Each
    # entry is held within 2% of the steps' reach (steps * lr; a wrong or
    # missed update is off by ~lr) and each leaf's update within 1e-3 of its
    # norm.
    g, w = _flat(_np(tstate.params)), _flat(state.params)
    start = _flat(v["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=0.02 * steps * o["lr"], err_msg=k)
        dg, dw = (g[k] - start[k]).astype(np.float64), (w[k] - start[k]).astype(np.float64)
        assert np.linalg.norm(dg - dw) <= 1e-3 * np.linalg.norm(dw) + 1e-12, k


def _reference_state_dict(name, seed=0):
    """A reference-layout CLAP checkpoint (``HTSAT-BERT-ZS.pt`` keys) with a
    Cnn14 (4, 8) audio tower over 16 mels and the named HF-layout text tower."""
    from test_torch_cnn_ase import cnn_reference_state_dict

    sd = {k: v for k, v in cnn_reference_state_dict(seed).items()
          if not k.startswith("text_encoder.")}
    tower = (hf_gpt2_state_dict(GPT2, seed) if name == "gpt2-tiny"
             else hf_clip_state_dict(CLIP, seed))
    sd.update({f"text_encoder.text_encoder.{k}": torch.from_numpy(np.asarray(v))
               for k, v in tower.items()})
    return sd


@pytest.mark.parametrize("name", ["gpt2-tiny", "clip-tiny"])
def test_convert_ase_reads_both_towers_as_jax(name):
    from zs_aac_tpu.models.convert import convert_ase as jax_convert_ase

    sd = _reference_state_dict(name)
    want = _flat(jax_convert_ase(sd, jase.ASEConfig(**ase_kwargs(name))))
    got = _flat(_np(convert_ase(sd, tase.ASEConfig(**ase_kwargs(name)), device="cpu")))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_extract_bank_with_a_gpt2_tower_matches_jax(tmp_path):
    """``extract.main`` with a GPT-2 tower (config read by ``load_config``)
    against the JAX package's encoders on the same reference checkpoint."""
    from test_torch_extract import absolute_manifest, assert_banks_match, make_dataset
    from zs_aac_tpu.data.bert_tokenizer import WordPieceTokenizer
    from zs_aac_tpu.data.text_transform import text_preprocess
    from zs_aac_tpu.models.convert import convert_ase as jax_convert_ase
    from zs_aac_tpu.ops.logmel import LogMelConfig
    from zs_aac_tpu.pipeline.extract import extract_audio_text_bank
    from zs_aac_tpu.train.contrastive import make_encode_fns
    from zs_aac_tpu_torch.pipeline import extract

    name = "gpt2-tiny"
    data = tmp_path / "data" / "train"
    make_dataset(str(data), n=3)
    absolute_manifest(str(data))
    sd = _reference_state_dict(name, seed=1)
    torch.save(sd, tmp_path / "ase.pt")
    audio_args = {"sr": 32000, "n_fft": 1024, "hop_length": 320, "f_min": 50, "f_max": 14000,
                  "n_mels": 16, "max_length": 1, "mono": True}
    config = {"audio_args": audio_args, "audio_encoder_args": {"type": "cnn", "model": "Cnn14"},
              "audio_channels": list(CHANNELS), "embed_size": EMBED,
              "text_encoder_args": {"type": name, "vocab": str(data / "vocab.txt")},
              "training": {"spec_augmentation": False}, "compute_dtype": "float32"}
    (tmp_path / "extract.json").write_text(json.dumps(config))
    extract.main(["--config", str(tmp_path / "extract.json"), "--ckpt", str(tmp_path / "ase.pt"),
                  "--dataset_path", str(tmp_path / "data"), "--out_path", str(tmp_path / "out"),
                  "--splits", "train", "--batch", "2", "--device", "cpu"])
    with open(tmp_path / "out" / "train" / "clap_embedding" / "ZS" / "data.pkl", "rb") as f:
        got = pickle.load(f)

    jcfg = jase.ASEConfig(**ase_kwargs(name))
    jv = jax.tree.map(jnp.asarray, jax_convert_ase(sd, jcfg))
    enc_a, enc_t = make_encode_fns(jase.ASE(jcfg), LogMelConfig.from_dict(audio_args),
                                   mel_impl="xla")
    tok = WordPieceTokenizer.from_file(str(data / "vocab.txt"))

    def encode_text(texts):
        ids, mask = tok.batch_encode([text_preprocess(t) for t in texts], max_length=30,
                                     pad_to_max=True)
        return np.asarray(enc_t(jv, jnp.asarray(ids), jnp.asarray(mask)), np.float32)

    want = extract_audio_text_bank(lambda w: np.asarray(enc_a(jv, jnp.asarray(w)), np.float32),
                                   encode_text, str(data), True, audio_args, 2)
    assert_banks_match(got, want, tol=TOL)


def test_pretrain_driver_trains_a_gpt2_tower(tmp_path, monkeypatch):
    """``pretrain.main`` for 2 steps with a Cnn14 + GPT-2 ASE on the CPU:
    its checkpoint holds the JAX init's tree, and the tower moved."""
    import yaml

    from test_retrieval_pipeline import _mk_corpus
    from test_torch_pretrain import _config
    from zs_aac_tpu_torch.train import pretrain

    monkeypatch.setenv("WANDB_MODE", "disabled")
    root = str(tmp_path)
    config = _config(root, _mk_corpus(root, n_audio=8))
    config["audio_encoder_args"] = {"type": "cnn", "model": "Cnn14"}
    config["audio_channels"] = list(CHANNELS)
    config["audio_args"]["n_mels"] = 64
    config["embed_size"] = EMBED
    config["text_encoder_args"]["type"] = "gpt2-tiny"
    del config["htsat_kwargs"]
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    ckpt_dir = pretrain.main(["-c", str(path), "--max_steps", "2", "--max_val_batches", "1",
                              "--device", "cpu"])
    saved = torch.load(os.path.join(ckpt_dir, "best_model.ckpt"), map_location="cpu",
                       weights_only=True)
    assert saved["step"] == 2
    _, ref = jax_variables("gpt2-tiny")
    assert _shapes(_np(saved["params"])) == _shapes(ref["params"])
    ase, cfg = pretrain.build_ase_from_config(config, device="cpu")
    start = tase.init_ase(cfg, seed=config["seed"], device="cpu")["params"]["text_enc"]
    moved = saved["params"]["text_enc"]["h0"]["c_fc"]["kernel"] - start["h0"]["c_fc"]["kernel"]
    assert np.isfinite(moved.numpy()).all()


# --- the committed record and MAGIC ------------------------------------------------


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    return testdata.stage_tiny_text_towers(tmp_path_factory.mktemp("towers"))


@pytest.mark.parametrize("name", testdata.TEXT_TOWERS)
def test_committed_record_reproduced(staged, name):
    """The port reproduces the JAX-recorded hidden states and embeddings of
    the committed checkpoints, and the record is what JAX computes now."""
    from zs_aac_tpu.utils.checkpoints import load_params as jax_load_params
    from zs_aac_tpu_torch.utils.checkpoints import load_params

    rec = staged["expected"]
    ids, mask = np.asarray(rec["ids"], np.int32), np.asarray(rec["mask"], np.int32)
    variables = from_jax_params(load_params(staged[name]), device="cpu")
    ase = tase.ASE(tase.ASEConfig(**ase_kwargs(name)))
    hidden = ase.text_enc.apply(variables["params"]["text_enc"], torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    emb = ase.encode_text(variables, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(hidden, np.asarray(rec[name]["hidden"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(emb, np.asarray(rec[name]["embeddings"]), rtol=0, atol=TOL)
    cfg = jase.ASEConfig(**ase_kwargs(name))
    shapes = jax.eval_shape(lambda r: jase.ASE(cfg).init(
        {"params": r}, jnp.zeros((1, 64, 64)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32), jnp.arange(1), train=False), jax.random.key(0))
    jv = jax_load_params(staged[name], jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    want = np.asarray(jax.jit(lambda v, i, m: jase.ASE(cfg).apply(
        v, i, m, method=jase.ASE.encode_text))(jv, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(want, np.asarray(rec[name]["embeddings"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", testdata.TEXT_TOWERS)
def test_float_magic_captions_match_jax_record(staged, name, tmp_path):
    from test_torch_predict import _captions, _port_predict

    run = testdata.stage_tiny_captioner(tmp_path / "cap")
    _port_predict(run["run_dir"], run["test_bank"],
                  ["--magic", "--magic_width", "5", "--clap_ckpt", staged[name]])
    assert _captions(run["run_dir"]) == staged["expected"][name]["magic_captions"]


@pytest.mark.parametrize("name", testdata.TEXT_TOWERS)
def test_q8_tower_refused_for_the_towers_in_both_packages(staged, name):
    from zs_aac_tpu.decoding import magic as jmagic
    from zs_aac_tpu_torch.decoding import magic

    with pytest.raises(ValueError, match="BERT-family"):
        magic._load_ase_text_encoder(staged[name], q8_tower=True, device="cpu")
    with pytest.raises(ValueError, match="BERT-family"):
        jmagic._load_ase_text_encoder(staged[name], q8_tower=True)
    enc = magic._load_ase_text_encoder(staged[name], device="cpu")
    emb = enc(["a dog barks", "rain"]).numpy()
    np.testing.assert_allclose(emb, np.asarray(staged["expected"][name]["cls_embedding"])[None]
                               .repeat(2, 0), rtol=0, atol=TOL)


def _rounded(a):
    """Nested lists of floats at 7 significant digits (1e-7 relative, far
    inside the record's tolerance), to keep the file small."""
    return json.loads(json.dumps(np.vectorize(lambda x: float(f"{x:.7g}"))(
        np.asarray(a, np.float64)).tolist()))


def write_fixture():
    """Write ``testdata/tiny_text_towers/`` with the JAX package (see
    ``zs_aac_tpu_torch/testdata/__init__.py``)."""
    import shutil
    import tempfile

    from test_torch_predict import _captions, _jax_predict
    from zs_aac_tpu.decoding import magic as jmagic
    from zs_aac_tpu.utils.checkpoints import save_params

    out = testdata.TINY_TEXT_TOWERS_DIR
    out.mkdir(exist_ok=True)
    shutil.copy(testdata.TINY_CLAP_DIR / "vocab.txt", out / "vocab.txt")
    ids, mask = tower_ids(64)
    record = {"ids": ids.tolist(), "mask": mask.tolist()}
    for seed, name in enumerate(testdata.TEXT_TOWERS):
        cfg, v = jax_init(name, seed=10 + seed)
        save_params(str(out / f"{name}.msgpack"), v)
        sidecar = {"ase_config": {**ase_kwargs(name), "audio_channels": list(CHANNELS)},
                   "bert_tokenizer": "vocab.txt"}
        (out / f"{name}.msgpack.json").write_text(json.dumps(sidecar, indent=1))
        jv = jax.tree.map(jnp.asarray, v)
        tower = (jtt.GPT2TextEncoder(CFGS[name][1]) if name == "gpt2-tiny"
                 else jtt.CLIPTextEncoder(CFGS[name][1]))
        hidden = tower.apply({"params": jv["params"]["text_enc"]}, jnp.asarray(ids),
                             jnp.asarray(mask))
        emb = jase.ASE(cfg).apply(jv, jnp.asarray(ids), jnp.asarray(mask),
                                  method=jase.ASE.encode_text)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, f"{name}.msgpack")
            shutil.copy(out / f"{name}.msgpack", ckpt)
            with open(ckpt + ".json", "w") as f:
                json.dump({**sidecar, "bert_tokenizer": str(out / "vocab.txt")}, f)
            cls = np.asarray(jmagic._load_ase_text_encoder(ckpt)(["a dog barks"]))[0]
            run = testdata.stage_tiny_captioner(os.path.join(tmp, "cap"))
            _jax_predict(run["run_dir"], run["test_bank"],
                         ["--magic", "--magic_width", "5", "--clap_ckpt", ckpt])
            captions = _captions(run["run_dir"])
        record[name] = {"hidden": _rounded(hidden), "embeddings": _rounded(emb),
                        "cls_embedding": _rounded(cls), "magic_captions": captions}
    (out / "expected.json").write_text(json.dumps(record))
    print(f"wrote {out}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        write_fixture()
    else:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_text_towers.py --write-fixture")
