"""The beam search's opt-in bf16 attention softmax (``--bf16_softmax``)
against the JAX package's.

JAX computes it in its beam steps (``models/gpt2.py::gpt2_step_beam``
lines 767-786, ``gpt2_step_beam_q8`` lines 462-474): the scores rounded to
bf16, ``e = bf16(exp(bf16(s - max)))``, an fp32 sum of ``e``, ``p =
x.dtype(e) * x.dtype(1 / sum)``. The port computes it in ``gpt2_step``
(float beam) and in K1's plain version (``decode_attn_q8_plain``, the int8
beam); K1's CUDA instantiation is held to the plain version on the card.

XLA's CPU backend, left to itself, drops the bf16 rounding of ``e`` where
it is read back in fp32 (``xla_allow_excess_precision``: it sums and scales
the fp32 exponentials). The JAX references below are compiled with that
option off, so they compute the arithmetic their source states.

- K1's plan takes the softmax dtype and gives both instantiations one plan.
- The attention alone: the plain version against the JAX branch on the same
  fp32 scores, run eagerly (op by op, as written; under ``jax.jit`` XLA
  would also divide by 127 as a multiply by the reciprocal): o within atol
  1e-6, the cache row and its scales bitwise.
- One decode step at K = 1: the port's ``gpt2_step_q8`` (plain attention)
  against JAX ``gpt2_step_beam_q8`` and ``gpt2_step`` against
  ``gpt2_step_beam``, both with ``softmax_dtype=bfloat16``, on a tiny random
  GPT-2 over 8 forced steps, in fp32 and bf16 activations. The bound on the
  logits (``_LOGIT_RTOL``, relative to the largest |logit|): the two sides
  form the fp32 scores in another order (JAX scales by ``1/sqrt(d)`` and the
  k-scale in two products, the port in one; the dot products sum in another
  order), so a score near a bf16 rounding boundary can round to the
  neighbouring bf16 value and move its ``e`` by one bf16 step (2^-8
  relative), which moves that head's output by at most 2^-8 of its largest
  value: 1e-3 in fp32 activations (measured: 1.6e-7, no score crossed a
  boundary). In bf16 activations every activation-dtype product also rounds
  (the int8 beam's ``p * v_scale`` rounds ``v_scale`` to bf16 first in JAX,
  after the product in the port) and the logits are bf16: 2^-6, four bf16
  steps (measured: half a step).
- The tiny random GPT-2 (``test_torch_beam.py``'s): ``beam_search_batched``
  and ``beam_search_batched_q8`` (plain attention) with
  ``fast_softmax=True``: tokens and lengths identical to JAX's, scores
  within rtol 1e-5.

The learned tiny captioner's agreement bound is held in
``tests/test_torch_beam.py`` (``test_bf16_softmax_beam_agreement_on_learned_weights``),
beside the other beam tests on that module's trained captioner.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_beam import CFG_J, CFG_T, SCORE_RTOL, STOP, _tiny
from zs_aac_tpu.decoding import beam as jbeam
from zs_aac_tpu.models import gpt2 as jg
from zs_aac_tpu.models.gpt2 import _quantize_vec
from zs_aac_tpu_torch.decoding import beam as tbeam
from zs_aac_tpu_torch.models import gpt2 as tg
from zs_aac_tpu_torch.models.convert import cast_floating
from zs_aac_tpu_torch.ops.decode_attn import (decode_attn_plan, decode_attn_q8,
                                              decode_attn_q8_plain)

torch.set_num_threads(2)

AS_WRITTEN = {"xla_allow_excess_precision": False}
_LOGIT_RTOL = {"fp32": 1e-3, "bf16": 2 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,n_rows", [(64, 77), (24, 10), (64, 3073)])
def test_plan_takes_the_softmax_dtype(dtype, d, n_rows):
    plan = decode_attn_plan(dtype, d, n_rows)
    assert decode_attn_plan(dtype, d, n_rows, torch.float32) == plan
    assert decode_attn_plan(dtype, d, n_rows, torch.bfloat16) == plan
    with pytest.raises(TypeError, match="softmax dtype"):
        decode_attn_plan(dtype, d, n_rows, torch.float16)


def _jax_bf16_attention(q, k, v, ck, cv, sk, sv, index):
    """One (b, h) strip of ``gpt2_step_beam_q8``'s bf16 branch at K = 1, fp32
    activations, the scores formed as K1 forms them."""
    T, d = ck.shape[2], q.shape[-1]
    qk_, sk_ = _quantize_vec(k)
    qv_, sv_ = _quantize_vec(v)
    ck, cv = ck.at[:, :, index].set(qk_), cv.at[:, :, index].set(qv_)
    sk, sv = sk.at[:, :, index].set(sk_), sv.at[:, :, index].set(sv_)
    bias = jnp.where(jnp.arange(T) <= index, 0.0, -1e9).astype(jnp.bfloat16)
    s = jnp.einsum("bhd,bhtd->bht", q, ck.astype(jnp.float32)) * (sk / np.sqrt(d))
    sf = s.astype(jnp.bfloat16) + bias
    e = jnp.exp(sf - jnp.max(sf, axis=-1, keepdims=True))
    denom = jnp.sum(e.astype(jnp.float32), axis=-1, keepdims=True)
    att = e.astype(jnp.float32) * (1.0 / denom).astype(jnp.float32)
    o = jnp.einsum("bht,bhtd->bhd", att * sv, cv.astype(jnp.float32))
    return o, ck, cv, sk, sv


@pytest.mark.parametrize("index", [0, 6, 12])
@pytest.mark.parametrize("d", [16, 64])
def test_plain_attention_matches_the_jax_branch(d, index):
    B, H, T = 3, 4, 13
    r = np.random.default_rng(d + index)
    arrays = (r.standard_normal((B, H, d)).astype(np.float32),
              (r.standard_normal((B, H, d)) * 2).astype(np.float32),
              r.standard_normal((B, H, d)).astype(np.float32),
              r.integers(-127, 128, (B, H, T, d)).astype(np.int8),
              r.integers(-127, 128, (B, H, T, d)).astype(np.int8),
              r.uniform(0.01, 0.2, (B, H, T)).astype(np.float32),
              r.uniform(0.001, 0.05, (B, H, T)).astype(np.float32))
    want = [np.asarray(x) for x in _jax_bf16_attention(*(jnp.asarray(a) for a in arrays),
                                                          index)]
    q, k, v, ck, cv, sk, sv = (torch.from_numpy(a.copy()) for a in arrays)
    before = (decode_attn_q8.launches, decode_attn_q8.bf16_softmax_launches)
    o = decode_attn_q8(q, k, v, ck, cv, sk, sv, index, torch.bfloat16)   # CPU: plain version
    assert (decode_attn_q8.launches, decode_attn_q8.bf16_softmax_launches) == before
    np.testing.assert_allclose(o.numpy(), want[0], atol=1e-6, rtol=0)
    for got, ref in zip((ck, cv, sk, sv), want[1:]):
        np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(TypeError, match="softmax dtype"):
        decode_attn_q8_plain(q, k, v, ck, cv, sk, sv, index, torch.float16)


def _as_written(fn, params, *args):
    """``fn(params, CFG_J, *args)`` jitted with XLA's excess precision off."""
    jitted = jax.jit(lambda p, *a: fn(p, CFG_J, *a))
    return jitted.lower(params, *args).compile(compiler_options=AS_WRITTEN)(params, *args)


def _steps(q8, dtype, n_steps=8, B=3, Lp=4):
    """Logits [n_steps, B, V] of JAX's beam step at K = 1 and of the port's
    step, both with the bf16 softmax, over the same forced tokens."""
    jp, tp, prefix = _tiny(11, B)
    if dtype == "bf16":
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = cast_floating(tp, torch.bfloat16)
        prefix_t = torch.from_numpy(prefix).to(torch.bfloat16)
    else:
        prefix_t = torch.from_numpy(prefix)
    prefix_j = jnp.asarray(prefix_t.float().numpy()).astype(jp["wte"].dtype)
    forced = np.random.default_rng(5).integers(0, CFG_J.vocab_size, (n_steps, B))
    T = Lp + n_steps
    anc = jnp.zeros((B, 1, T), jnp.int32)
    if q8:
        _, c1 = _as_written(jg.gpt2_prefill_q8, jp, prefix_j, jg.init_kv_cache_q8(CFG_J, B, T))
        jcache = jg.init_beam_cache_q8(CFG_J, c1, 1)
        jstep = jg.gpt2_step_beam_q8
        tcache = tg.init_kv_cache_q8(CFG_T, B, T, device="cpu")
        tg.gpt2_prefill_q8(tp, CFG_T, prefix_t, tcache)
    else:
        _, c1 = _as_written(jg.gpt2_prefill, jp, prefix_j,
                            jg.init_kv_cache(CFG_J, B, T, prefix_j.dtype))
        jcache = jg.init_beam_cache(CFG_J, c1, 1)
        jstep = jg.gpt2_step_beam
        tcache = tg.init_kv_cache(CFG_T, B, T, prefix_t.dtype, device="cpu")
        tg.gpt2_prefill(tp, CFG_T, prefix_t, tcache)

    def jax_step(params, emb, cache, anc, index):
        return jstep(params, CFG_J, emb, cache, anc, index, softmax_dtype=jnp.bfloat16)[:3]

    step = jax.jit(jax_step).lower(jp, jg.gpt2_embed(jp, jnp.asarray(forced[0])), jcache, anc,
                                   jnp.int32(Lp)).compile(compiler_options=AS_WRITTEN)
    want, got = [], []
    for i in range(n_steps):
        tok = forced[i]
        lj, jcache, anc = step(jp, jg.gpt2_embed(jp, jnp.asarray(tok)), jcache, anc,
                               jnp.int32(Lp + i))
        want.append(np.asarray(lj, np.float32))
        emb = tg.gpt2_embed(tp, torch.from_numpy(tok))
        if q8:
            lt, _ = tg.gpt2_step_q8(tp, CFG_T, emb, tcache, Lp + i, decode_attn_q8_plain,
                                    torch.bfloat16)
        else:
            lt, _ = tg.gpt2_step(tp, CFG_T, emb, tcache, Lp + i, softmax_dtype=torch.bfloat16)
        got.append(lt.numpy())
    return np.stack(want), np.stack(got)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("q8", [False, True], ids=["float", "q8"])
def test_step_matches_the_jax_beam_step(q8, dtype):
    want, got = _steps(q8, dtype)
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = _LOGIT_RTOL[dtype] * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)
    if dtype == "fp32":   # each step's best token too, where it is no near-tie
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 2 * tol
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def test_step_softmax_dtype_changes_the_float_step_only_through_the_softmax():
    """fp32 activations: the bf16-softmax step lies within the bf16
    softmax's rounding of the fp32-softmax step, and an unknown dtype is
    refused."""
    _, tp, prefix = _tiny(3, 2)
    out = []
    for smax in (torch.float32, torch.bfloat16):
        cache = tg.init_kv_cache(CFG_T, 2, 10, device="cpu")
        tg.gpt2_prefill(tp, CFG_T, torch.from_numpy(prefix), cache)
        emb = tg.gpt2_embed(tp, torch.tensor([1, 2]))
        out.append(tg.gpt2_step(tp, CFG_T, emb, cache, 4, softmax_dtype=smax)[0])
    assert 0 < (out[0] - out[1]).abs().max() < 0.05
    with pytest.raises(TypeError, match="softmax dtype"):
        tg.gpt2_step(tp, CFG_T, emb, cache, 5, softmax_dtype=torch.float16)


@pytest.mark.parametrize("q8", [False, True], ids=["float", "q8"])
@pytest.mark.parametrize("seed,beam,steps", [(4, 3, 12), (1, 3, 15)])
def test_beam_identical_to_jax(seed, beam, steps, q8):
    jp, tp, prefix = _tiny(seed, 3)
    jfn = jbeam.beam_search_batched_q8 if q8 else jbeam.beam_search_batched
    args = (jp, CFG_J, jnp.asarray(prefix), beam, steps, STOP, 1.0, True)
    wt, wl, ws = jfn.lower(*args).compile(compiler_options=AS_WRITTEN)(jp, jnp.asarray(prefix))
    x = torch.from_numpy(prefix)
    if q8:
        gt, gl, gs = tbeam.beam_search_batched_q8(tp, CFG_T, x, beam, steps, STOP, 1.0, True,
                                                  attention=decode_attn_q8_plain)
    else:
        gt, gl, gs = tbeam.beam_search_batched(tp, CFG_T, x, beam, steps, STOP, 1.0, True)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=SCORE_RTOL)
