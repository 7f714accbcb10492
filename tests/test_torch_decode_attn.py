"""Kernel K1 (int8-KV decode attention): the port's plain version against the
JAX package's ``gpt2_step_q8`` attention math. The CUDA kernel itself is
held against the plain version in tests/test_torch_kernels_cuda.py.

The JAX side below is ``models/gpt2.py::gpt2_step_q8`` lines 994-1007 for
one layer, built from that module's own ``_quantize_vec``. Tolerances: o
(|o| up to ~3 here) within atol 1e-5 + rtol 1e-5 in fp32 (summation order); the written cache row and its
scales bitwise equal (same quantization ops on the same inputs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zs_aac_tpu.models.gpt2 import _quantize_vec
from zs_aac_tpu_torch.ops.decode_attn import decode_attn_plan, decode_attn_q8

torch.set_num_threads(2)

H, T = 4, 13


def _inputs(B, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, d)).astype(np.float32)
    k = (r.standard_normal((B, H, d)) * 2).astype(np.float32)
    v = r.standard_normal((B, H, d)).astype(np.float32)
    ck = r.integers(-127, 128, (B, H, T, d)).astype(np.int8)
    cv = r.integers(-127, 128, (B, H, T, d)).astype(np.int8)
    sk = r.uniform(0.001, 0.05, (B, H, T)).astype(np.float32)
    sv = r.uniform(0.001, 0.05, (B, H, T)).astype(np.float32)
    return q, k, v, ck, cv, sk, sv


def _jax_reference(q, k, v, ck, cv, sk, sv, index):
    d = q.shape[-1]
    qk_, sk_ = _quantize_vec(jnp.asarray(k))
    qv_, sv_ = _quantize_vec(jnp.asarray(v))
    ck = jnp.asarray(ck).at[:, :, index].set(qk_)
    cv = jnp.asarray(cv).at[:, :, index].set(qv_)
    sk = jnp.asarray(sk).at[:, :, index].set(sk_)
    sv = jnp.asarray(sv).at[:, :, index].set(sv_)
    bias = jnp.where(jnp.arange(T) <= index, 0.0, -1e9).astype(jnp.float32)
    att = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q)[:, :, None], ck.astype(jnp.float32)) \
        * (sk[:, :, None, :] / np.sqrt(d)).astype(jnp.float32)
    att = jax.nn.softmax(att.astype(jnp.float32) + bias, axis=-1)
    p = (att * sv[:, :, None, :]).astype(jnp.float32)
    o = jnp.einsum("bhqk,bhkd->bhqd", p, cv.astype(jnp.float32))[:, :, 0]
    return [np.asarray(x) for x in (o, ck, cv, sk, sv)]


@pytest.mark.parametrize("index", [0, 6, T - 1])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_plain_matches_jax_gpt2_step_q8_attention(B, d, index):
    arrays = _inputs(B, d, seed=B * 100 + d + index)
    want = _jax_reference(*arrays, index)
    q, k, v, ck, cv, sk, sv = (torch.from_numpy(a.copy()) for a in arrays)
    before = decode_attn_q8.launches
    o = decode_attn_q8(q, k, v, ck, cv, sk, sv, index)   # CPU tensors: plain version
    assert decode_attn_q8.launches == before
    assert o.shape == (B, H, d) and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want[0], atol=1e-5, rtol=1e-5)
    for got, ref in zip((ck, cv, sk, sv), want[1:]):
        np.testing.assert_array_equal(got.numpy(), ref)   # row index written, others kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d,vec", [(16, 16), (24, 8), (64, 16), (128, 16), (12, 4), (6, 2),
                                   (5, 1), (2, 2)])
def test_plan_picks_the_widest_load_that_divides_a_row(d, vec, dtype):
    """A cache row is d // vec lanes of one vec-byte load each; 4 warps a
    block, one (b, h) each, at the decode's row counts."""
    for n_rows in (1, 13, 77):
        assert decode_attn_plan(dtype, d, n_rows) == (vec, 4)


def test_plan_halves_the_warps_for_long_caches_and_refuses_what_the_kernel_does_not_take():
    # the score strips: 4 bytes a row a warp within 48 KB
    assert decode_attn_plan(torch.bfloat16, 64, 3072) == (16, 4)
    assert decode_attn_plan(torch.bfloat16, 64, 3073) == (16, 2)
    assert decode_attn_plan(torch.bfloat16, 64, 12288) == (16, 1)
    with pytest.raises(ValueError, match="shared memory"):
        decode_attn_plan(torch.bfloat16, 64, 12289)
    with pytest.raises(ValueError, match="32"):
        decode_attn_plan(torch.float32, 33, 8)          # 33 one-byte loads a row
    with pytest.raises(ValueError):
        decode_attn_plan(torch.float32, 0, 8)
    for dtype in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(TypeError):
            decode_attn_plan(dtype, 64, 8)
