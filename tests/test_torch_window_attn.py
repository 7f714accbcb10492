"""The port's window attention and whole Swin block (K5's and K3's plain
versions, and the wrappers' CPU route) against the JAX package: its
pure-jnp twins and its Pallas kernels, which run in interpret mode on the
CPU as ``tests/test_htsat.py`` runs them.

Tolerance: fp32 throughout; the two sides differ in summation order only,
so outputs of magnitude ~5 agree to 2e-5 (attention) and 5e-5 (block, whose
fc1 sums run over up to 8192 hidden units).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zs_aac_tpu.models.htsat import _shift_attn_mask
from zs_aac_tpu.ops import window_attn as jw
from zs_aac_tpu_torch.ops import window_attn as tw

torch.set_num_threads(2)

# (B, H, W, C, heads, window, shift, hidden)
CASES = {
    "tiny-shifted": (2, 16, 16, 32, 4, 4, 2, 128),
    "tiny-unshifted": (2, 8, 8, 16, 2, 4, 0, 64),
    "stage1-like-shifted": (1, 16, 16, 96, 4, 8, 4, 384),
    "stage1-like": (1, 16, 16, 96, 4, 8, 0, 384),
    "stage4-like": (1, 8, 8, 192, 8, 8, 0, 768),
}
# the K4 function: an MLP far wider than 4*C (tests/test_htsat.py's streamed case)
WIDE = (2, 16, 16, 128, 4, 8, 4, 8192)


def _inputs(B, H, W, C, heads, window, shift, hidden, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    N, nH, nW = window * window, H // window, W // window
    x = f(B, H, W, C) * 20
    weights = [f(C) + 1, f(C), f(C, 3 * C), f(3 * C), f(C, C), f(C), f(C) + 1, f(C),
               f(C, hidden), f(hidden), f(hidden, C), f(C)]
    rpb = f(heads, N, N) * 4
    mask = _shift_attn_mask(H, W, window, shift)
    return x, weights, rpb, mask, nH, nW


def _both(case, seed=0):
    B, H, W, C, heads, window, shift, hidden = case
    x, weights, rpb, mask, nH, nW = _inputs(*case, seed=seed)
    jb = jw.build_window_bias(jnp.asarray(rpb), None if mask is None else jnp.asarray(mask),
                              nH, nW)
    tb = tw.build_window_bias(torch.from_numpy(rpb), mask, nH, nW)
    j = dict(x=jnp.asarray(x), w=[jnp.asarray(a) for a in weights], bias=jb)
    t = dict(x=torch.from_numpy(x), w=[torch.from_numpy(a) for a in weights], bias=tb)
    return j, t, (window, heads, shift)


@pytest.mark.parametrize("shift", [0, 2])
def test_build_window_bias_matches_jax(shift):
    _, t, _ = _both((1, 8, 8, 16, 2, 4, shift, 64))
    j, _, _ = _both((1, 8, 8, 16, 2, 4, shift, 64))
    np.testing.assert_array_equal(t["bias"].numpy(), np.asarray(j["bias"]))
    assert t["bias"].dtype == torch.float32 and t["bias"].shape == (2, 2, 2, 16, 16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_attention_matches_jax(name):
    j, t, (window, heads, shift) = _both(CASES[name])
    want_twin = np.asarray(jw._reference_window_attention(
        j["x"], *j["w"][2:6], j["bias"], window, heads, shift))
    want_kernel = np.asarray(jw.fused_window_attention(
        j["x"], *j["w"][2:6], j["bias"], window, heads, shift))
    plain = tw.window_attention_plain(t["x"], *t["w"][2:6], t["bias"], window, heads, shift)
    before = tw.fused_window_attention.launches
    routed = tw.fused_window_attention(t["x"], *t["w"][2:6], t["bias"], window, heads, shift)
    assert tw.fused_window_attention.launches == before
    torch.testing.assert_close(routed, plain, rtol=0, atol=0)
    np.testing.assert_allclose(plain.numpy(), want_twin, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), want_kernel, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES) + ["wide-mlp"])
def test_swin_block_matches_jax(name):
    case = WIDE if name == "wide-mlp" else CASES[name]
    j, t, (window, heads, shift) = _both(case, seed=1)
    want_twin = np.asarray(jw._reference_swin_block(
        j["x"], *j["w"], j["bias"], window=window, num_heads=heads, shift=shift, eps=1e-6))
    want_kernel = np.asarray(jw.fused_swin_block(
        j["x"], *j["w"], j["bias"], window, heads, shift, 1e-6))
    plain = tw.swin_block_plain(t["x"], *t["w"], t["bias"], window, heads, shift, 1e-6)
    before = tw.fused_swin_block.launches
    routed = tw.fused_swin_block(t["x"], *t["w"], t["bias"], window, heads, shift, 1e-6)
    assert tw.fused_swin_block.launches == before
    torch.testing.assert_close(routed, plain, rtol=0, atol=0)
    np.testing.assert_allclose(plain.numpy(), want_twin, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(plain.numpy(), want_kernel, rtol=5e-5, atol=5e-5)


def test_bf16_plain_versions_round_like_the_twins():
    """In bf16 the port rounds once per listed point where the JAX twin may
    round twice (a matmul output, then its bias add), and keeps the scores
    in fp32; the two stay within a few bf16 steps (2**-8 relative) of each
    other at |out| ~ 5."""
    case = CASES["stage1-like-shifted"]
    j, t, (window, heads, shift) = _both(case, seed=2)
    jx = [a.astype(jnp.bfloat16) for a in [j["x"]] + j["w"]]
    tx = [a.to(torch.bfloat16) for a in [t["x"]] + t["w"]]
    want = np.asarray(jw._reference_swin_block(*jx, j["bias"], window=window, num_heads=heads,
                                               shift=shift, eps=1e-6).astype(jnp.float32))
    got = tw.swin_block_plain(*tx, t["bias"], window, heads, shift, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.15)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 8, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tw.fused_window_attention(x, x, x, x, x, x, 4, 2, 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        tw.fused_swin_block(x, *[x] * 13, 4, 2, 0, 1e-6)
