"""The port's Mistral (``models/mistral.py``), its decode and its captioner
against the JAX package, on the CPU in fp32.

Seeded numpy inputs and a JAX-initialized base (moved into the port by
``from_jax_params``) go through both packages, at ``tests/test_mistral.py``'s
small config and at one whose sliding window (4) is shorter than the
sequences. Tolerances:

- forward (attention mask, nonzero LoRA) and cached logits: 1e-5 absolute
  (the two packages' fp32 matmuls sum in other orders: ~1e-7 here);
- the int8 cache after a prefill and 4 steps: int8 bytes equal, scales to
  rtol 1e-6 (max|k|/127 of vectors from two summation orders; ``ROADMAP.md``
  section C);
- ``quantize_mistral_int8`` (w8/w8a8, fused or not): int8 weights and scales
  bitwise equal to the JAX function's (eager); the w8a8 forward within 1e-4
  of max|logit|;
- greedy decode: tokens and lengths equal, float and int8 caches, w8a8,
  fused, with an EOS that stops rows early;
- the captioner's embeddings, train logits and loss: 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zs_aac_tpu.decoding.greedy import mistral_greedy_decode as j_decode
from zs_aac_tpu.models import caption_mistral as jcm
from zs_aac_tpu.models import mistral as jm
from zs_aac_tpu_torch.decoding.greedy import mistral_greedy_decode as t_decode
from zs_aac_tpu_torch.models import caption_mistral as tcm
from zs_aac_tpu_torch.models import mistral as tm
from zs_aac_tpu_torch.models.convert import from_jax_params, to_jax_params

torch.set_num_threads(2)

BASE = dict(vocab_size=123, hidden_size=32, n_layers=2, n_heads=4, n_kv_heads=2,
            intermediate_size=64, sliding_window=64, max_positions=64)
CONFIGS = {"mcfg": BASE, "window4": {**BASE, "sliding_window": 4}}
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(name, seed=0):
    J, T = jm.MistralConfig(**CONFIGS[name]), tm.MistralConfig(**CONFIGS[name])
    jp = jm.init_mistral(jax.random.key(seed), J, jnp.float32)
    lora = jm.init_lora(jax.random.key(seed + 1), J, r=4, alpha=8)
    rng = np.random.default_rng(seed + 2)
    lora = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                                              * 0.05) if x.ndim == 2 else x, lora)
    tp = from_jax_params(_np(jp), device="cpu")
    tl = from_jax_params({"mapper": {"fc0": {"kernel": np.zeros((2, 2), np.float32)}},
                          "lora": _np(lora)}, device="cpu")["lora"]
    return J, T, jp, lora, tp, tl


def _emb(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, with_lora):
    J, T, jp, lora, tp, tl = _setup(name)
    emb = _emb((2, 9, 32), 3)
    mask = np.ones((2, 9), np.float32)
    mask[1, 6:] = 0.0
    want = np.asarray(jm.mistral_forward(jp, J, jnp.asarray(emb), jnp.asarray(mask),
                                         lora if with_lora else None))
    got = tm.mistral_forward(tp, T, torch.from_numpy(emb), torch.from_numpy(mask),
                             tl if with_lora else None).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("q8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_steps_match_jax(name, q8):
    J, T, jp, lora, tp, tl = _setup(name)
    Lp, steps, B = 5, 4, 2
    emb = _emb((B, Lp + steps, 32), 4)
    jc = jm.init_mistral_cache_q8(J, B, 12) if q8 else jm.init_mistral_cache(J, B, 12,
                                                                              jnp.float32)
    tc = (tm.init_mistral_cache_q8(T, B, 12, device="cpu") if q8
          else tm.init_mistral_cache(T, B, 12, torch.float32, device="cpu"))
    want, jc = jm.mistral_prefill(jp, J, jnp.asarray(emb[:, :Lp]), jc, lora)
    got, tc = tm.mistral_prefill(tp, T, torch.from_numpy(emb[:, :Lp]), tc, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    for t in range(steps):
        want, jc = jm.mistral_step(jp, J, jnp.asarray(emb[:, Lp + t]), jc, jnp.asarray(Lp + t),
                                   lora)
        got, tc = tm.mistral_step(tp, T, torch.from_numpy(emb[:, Lp + t]), tc, Lp + t, tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0,
                                   err_msg=f"step {t}")
    n = Lp + steps
    if q8:
        for i in range(J.n_layers):
            for j in (0, 1):
                assert np.array_equal(tc[i][j][:, :n].numpy(), np.asarray(jc[i][j])[:, :n])
            for j in (2, 3):
                np.testing.assert_allclose(tc[i][j][:, :n].numpy(), np.asarray(jc[i][j])[:, :n],
                                           rtol=1e-6, atol=0)
    else:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc[k][..., :n, :].numpy(), np.asarray(jc[k])[..., :n, :],
                                       atol=TOL, rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list, tuple)):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _tensors(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_tensors(v, f"{prefix}{k}/") if isinstance(v, (dict, list, tuple))
                   else {prefix + k: v})
    return out


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_matches_jax_bitwise(mode, fuse):
    J, T, jp, lora, tp, tl = _setup("mcfg")
    want = _leaves(_np(jm.quantize_mistral_int8(jp, mode, fuse)))
    qt = tm.quantize_mistral_int8(tp, mode, fuse)
    got = _leaves(to_jax_params(qt))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # the port's int8 lm_head is padded to 128 columns, its logits cut to 123
    assert qt["lm_head"]["w"].shape == (32, 128)
    emb = _emb((2, 5, 32), 5, 1.0)
    ref = np.asarray(jm.mistral_forward(jm.quantize_mistral_int8(jp, mode, fuse), J,
                                        jnp.asarray(emb), None, lora))
    out = tm.mistral_forward(qt, T, torch.from_numpy(emb), None, tl).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_from_jax_params_reads_a_quantized_tree():
    """A JAX-quantized tree through the bridge serves the same logits as the
    port's own quantization (the lm_head padded on the way in)."""
    J, T, jp, lora, tp, tl = _setup("mcfg")
    qj = from_jax_params(_np(jm.quantize_mistral_int8(jp, "w8a8", True)), device="cpu")
    qt = tm.quantize_mistral_int8(tp, "w8a8", True)
    emb = torch.from_numpy(_emb((2, 5, 32), 6))
    assert torch.equal(tm.mistral_forward(qj, T, emb, None, tl),
                       tm.mistral_forward(qt, T, emb, None, tl))


def _decode_case(case):
    J, T, jp, lora, tp, tl = _setup("window4" if case == "window4" else "mcfg")
    if case in ("w8a8", "w8a8_q8", "fused_q8"):
        fuse = case == "fused_q8"
        jp, tp = jm.quantize_mistral_int8(jp, "w8a8", fuse), tm.quantize_mistral_int8(tp, "w8a8",
                                                                                      fuse)
    return J, T, jp, lora, tp, tl, case.endswith("q8")


@pytest.mark.parametrize("stop", ["never", "early"])
@pytest.mark.parametrize("case", ["float", "q8", "window4", "w8a8", "w8a8_q8", "fused_q8"])
def test_greedy_decode_matches_jax(case, stop):
    J, T, jp, lora, tp, tl, q8 = _decode_case(case)
    emb = _emb((3, 5, 32), 7, 0.5)
    eos = 10 ** 9
    want_t, want_l = j_decode(jp, J, jnp.asarray(emb), lora, 12, eos, q8_cache=q8)
    if stop == "early":
        # rows stop where this token first comes (row 0 at step 3), the rest run on
        eos = int(np.asarray(want_t)[0, 3])
        want_t, want_l = j_decode(jp, J, jnp.asarray(emb), lora, 12, eos, q8_cache=q8)
        assert int(np.asarray(want_l).min()) < 12
    got_t, got_l = t_decode(tp, T, torch.from_numpy(emb), tl, 12, eos, q8_cache=q8)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_fused_and_unfused_decode_equal():
    J, T, jp, lora, tp, tl = _setup("mcfg")
    emb = torch.from_numpy(_emb((3, 5, 32), 8, 0.5))
    outs = [t_decode(tm.quantize_mistral_int8(tp, "w8a8", fuse), T, emb, tl, 12, 10 ** 9,
                     q8_cache=True) for fuse in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _captioner(islang=3, mapping_type="mlp"):
    J = jm.MistralConfig(**BASE)
    kw = dict(prefix_length=3, prefix_size=8, clip_length=3, num_layers=2, islang=islang,
              max_seq_len=10, lora_r=2, lora_alpha=4, mapping_type=mapping_type)
    jcfg = jcm.MistralCaptionConfig(**kw, mistral=J)
    tcfg = tcm.MistralCaptionConfig(**kw, mistral=tm.MistralConfig(**BASE))
    params = jcm.init_mistral_caption(jax.random.key(0), jcfg,
                                      jm.init_mistral(jax.random.key(1), J, jnp.float32))
    rng = np.random.default_rng(9)
    params["lora"] = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                                        .astype(np.float32) * 0.05)
                                  if x.ndim == 2 else x, params["lora"])
    return jcfg, tcfg, params, from_jax_params(_np(params), device="cpu")


@pytest.mark.parametrize("mapping_type", ["mlp", "transformer"])
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard_prompt"])
def test_captioner_matches_jax(hard, mapping_type):
    jcfg, tcfg, jp, tp = _captioner(mapping_type=mapping_type)
    rng = np.random.default_rng(10)
    B, S, H = 2, 10, 4
    tokens = rng.integers(1, 100, (B, S))
    tokens[1, 7:] = 0
    prefix = rng.standard_normal((B, 8)).astype(np.float32)
    mask = np.ones((B, 3 + S), np.float32)
    mask[1, 3 + 7:] = 0.0
    hp = rng.integers(1, 100, (B, H)) if hard else None
    hm = np.ones((B, H), np.float32) if hard else None
    if hard:
        hm[0, -1] = 0.0
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    want = np.asarray(jcm.mistral_caption_embeddings(jp, jcfg, j(prefix), j(hp), j(tokens)))
    got = tcm.mistral_caption_embeddings(tp, tcfg, t(prefix), t(hp), t(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    want = jcm.mistral_caption_train_logits(jp, jcfg, j(tokens), j(prefix), j(mask), j(hp), j(hm))
    got = tcm.mistral_caption_train_logits(tp, tcfg, t(tokens), t(prefix), t(mask), t(hp), t(hm))
    assert got.shape == want.shape == (B, S - 3, 123)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    lw = float(jcm.mistral_caption_loss(want, j(tokens), 3))
    lg = float(tcm.mistral_caption_loss(got, t(tokens), 3).detach())
    assert abs(lg - lw) <= TOL * abs(lw)


def test_convert_mistral_matches_jax_and_hf():
    import transformers

    cfg = transformers.MistralConfig(
        vocab_size=123, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=64,
        sliding_window=64, rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(cfg).eval()
    T = tm.MistralConfig(**BASE)
    tp = tm.convert_mistral(hf.state_dict(), T, device="cpu")
    want = _leaves(jm.convert_mistral(hf.state_dict(), jm.MistralConfig(**BASE)))
    got = _leaves(to_jax_params(tp))
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    ids = np.random.default_rng(11).integers(0, 123, (2, 9))
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids)).logits
    out = tm.mistral_forward(tp, T, tm.mistral_embed(tp, torch.from_numpy(ids)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_init_trees_match_jax_shapes():
    J, T = jm.MistralConfig(**BASE), tm.MistralConfig(**BASE)
    for jtree, ttree in (
            (jax.eval_shape(lambda k: jm.init_mistral(k, J), jax.random.key(0)),
             tm.init_mistral(T, 0, "cpu")),
            (jax.eval_shape(lambda k: jm.init_lora(k, J, 4, 8), jax.random.key(0)),
             tm.init_lora(T, 4, 8, 0, "cpu"))):
        want = {k: (v.shape, str(v.dtype)) for k, v in _leaves(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), jtree)).items()}
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in _tensors(ttree).items()}
        assert got == want
    lora = tm.init_lora(T, 4, 8, 0, "cpu")
    assert float(lora["r"]) == 4.0 and float(lora["alpha"]) == 8.0
    assert all(float(l["wq"]["b"].abs().max()) == 0.0 for l in lora["layers"])
    jmask = jm.lora_trainable_mask(jm.init_lora(jax.random.key(0), J, 4, 8))
    assert _leaves(tm.lora_trainable_mask(lora)) == _leaves(jmask)


def test_mistral_round_trips_through_the_bridge():
    """{"mapper", "lora", "mistral"} -> JAX tree -> port: every leaf
    (LoRA's 0-d r/alpha, the int8 base's leaves) comes back unchanged."""
    jcfg, tcfg, jp, tp = _captioner()
    tp["mistral"] = tm.quantize_mistral_int8(tp["mistral"], "w8a8", True)
    host = to_jax_params(tp)
    assert host["lora"]["r"].shape == () and host["lora"]["r"].dtype == np.float32
    again = from_jax_params(host, device="cpu")
    a, b = _leaves(to_jax_params(again)), _leaves(host)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    assert again["mistral"]["lm_head"]["w"].shape == tp["mistral"]["lm_head"]["w"].shape
