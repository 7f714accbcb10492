"""The port's train-mode Swin block pieces against the JAX package: the K7
forward (``swin_block_train_plain``, ``fused_swin_block_train``), the K8/K9
backward halves (``mlp_bwd_plain``, ``attn_ln1_bwd_plain``), the K6 backward
(``window_attention_bwd_plain``) and the differentiable wrappers' CPU route.
The JAX side runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_htsat.py`` does, and its pure-jnp twins.

Tolerance: fp32 at rtol 1e-3 / atol 1e-4, the JAX package's own for these
gradients (``tests/test_htsat.py::test_fused_swin_block_train_bwd_direct``):
both sides differ in summation order, and the weight gradients sum over
every token. The JAX train kernels use an Abramowitz-Stegun erf in the GELU
derivative (~1e-7 absolute) where the port is exact. Drop-path keep scales
hold a kept-and-rescaled row (1.25) and a dropped one (0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs_aac_tpu.models.htsat import _shift_attn_mask
from zs_aac_tpu.ops import window_attn as jw
from zs_aac_tpu_torch.ops import window_attn as tw

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 1e-4
# (B, H, W, C, heads, window, shift): stage-1-like with shift 0 and 4, and a
# window-4 shape with shift 0 and 2
CASES = {
    "w8-shift0": (2, 16, 16, 96, 4, 8, 0),
    "w8-shift4": (2, 16, 16, 96, 4, 8, 4),
    "w4-shift0": (2, 8, 8, 32, 4, 4, 0),
    "w4-shift2": (2, 8, 8, 32, 4, 4, 2),
}
EPS = 1e-6


def _inputs(case, seed=13):
    B, H, W, C, heads, window, shift = case
    hidden = 4 * C
    N, nH, nW = window * window, H // window, W // window
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    x = r(B, H, W, C)
    weights = [r(C) + 1.0, r(C), r(C, 3 * C), r(3 * C), r(C, C), r(C), r(C) + 1.0, r(C),
               r(C, hidden), r(hidden), r(hidden, C), r(C)]
    rpb = r(heads, N, N)
    mask = _shift_attn_mask(H, W, window, shift)
    m1 = np.asarray([1.25, 0.0], np.float32)
    m2 = np.asarray([0.0, 1.25], np.float32)
    g = r(B, H, W, C) * 20.0
    jbias = jw.build_window_bias(jnp.asarray(rpb), None if mask is None else jnp.asarray(mask),
                                 nH, nW)
    tbias = tw.build_window_bias(torch.from_numpy(rpb), mask, nH, nW)
    return dict(x=x, w=weights, m1=m1, m2=m2, g=g, jbias=jbias, tbias=tbias,
                cfg=(window, heads, shift))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


NAMES = ["x", "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_s", "ln2_b",
         "fc1_w", "fc1_b", "fc2_w", "fc2_b", "bias"]


def _port_block(d, route=tw.fused_swin_block_train):
    leaves = [torch.from_numpy(a).requires_grad_() for a in [d["x"]] + d["w"]]
    bias = d["tbias"].clone().requires_grad_()
    m1 = torch.from_numpy(d["m1"]).requires_grad_()
    m2 = torch.from_numpy(d["m2"]).requires_grad_()
    out = route(*leaves, bias, m1, m2, *d["cfg"], EPS)
    grads = torch.autograd.grad(out, leaves + [bias, m1, m2], torch.from_numpy(d["g"]))
    return out.detach(), grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_block_matches_jax_twin(name):
    """Forward and every input gradient against ``jax.vjp`` of the twin
    ``_reference_swin_block_train``; mask cotangents are zero."""
    d = _inputs(CASES[name])
    window, heads, shift = d["cfg"]
    f = functools.partial(jw._reference_swin_block_train, window=window, num_heads=heads,
                          shift=shift, eps=EPS)
    args = [jnp.asarray(a) for a in [d["x"]] + d["w"]] + [d["jbias"], jnp.asarray(d["m1"]),
                                                           jnp.asarray(d["m2"])]
    want_out, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(d["g"]))
    before = tw.fused_swin_block_train.launches
    out, got = _port_block(d)
    assert tw.fused_swin_block_train.launches == before   # the CPU route launches nothing
    _close(out, want_out, "out")
    for n, a, b in zip(NAMES, got, want):
        _close(a, b, n)
    assert not got[-1].any() and not got[-2].any()


@pytest.mark.parametrize("name", ["w8-shift0", "w8-shift4"])
def test_train_block_matches_jax_kernels(name):
    """The same against ``fused_swin_block_train`` itself: its Pallas forward
    (out and the saved y) and split Pallas backward, in interpret mode."""
    d = _inputs(CASES[name])
    window, heads, shift = d["cfg"]
    args = [jnp.asarray(a) for a in [d["x"]] + d["w"]] + [d["jbias"], jnp.asarray(d["m1"]),
                                                           jnp.asarray(d["m2"])]
    f = functools.partial(jw.fused_swin_block_train, window=window, num_heads=heads,
                          shift=shift, eps=EPS)
    want_out, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(d["g"]))
    _, want_y = jw._fused_swin_block_train_fwd_only(*args, window, heads, shift, EPS)
    out, got = _port_block(d)
    _close(out, want_out, "out")
    t = [torch.from_numpy(a) for a in [d["x"]] + d["w"]]
    _, y = tw.swin_block_train_plain(*t, d["tbias"], torch.from_numpy(d["m1"]),
                                     torch.from_numpy(d["m2"]), *d["cfg"], EPS)
    _close(y, want_y, "y")
    for n, a, b in zip(NAMES, got, want):
        _close(a, b, n)


@pytest.mark.parametrize("name", ["w8-shift4", "w4-shift2"])
def test_mlp_bwd_plain_matches_jax_kernel(name):
    d = _inputs(CASES[name], seed=3)
    x, w = d["x"], d["w"]
    y = x * 20.0            # a residual of the size the block's carries
    jargs = [jnp.asarray(a) for a in (y, d["g"], d["m2"], w[6], w[7], w[8], w[9], w[10])]
    want = jw._mlp_bwd_call(*jargs, EPS)
    got = tw.mlp_bwd_plain(*[torch.from_numpy(a) for a in (y, d["g"], d["m2"], w[6], w[7],
                                                            w[8], w[9], w[10])], EPS)
    assert len(got) == len(want) == 7
    for n, a, b in zip(["dy", "dln2_s", "dln2_b", "dfc1_w", "dfc1_b", "dfc2_w", "dfc2_b"],
                       got, want):
        _close(a, b, n)
    # a dropped row (m2 = 0) passes g through exactly
    np.testing.assert_array_equal(got[0][0].numpy(), d["g"][0])


@pytest.mark.parametrize("name", ["w8-shift0", "w8-shift4", "w4-shift2"])
def test_attn_ln1_bwd_plain_matches_jax_kernel(name):
    d = _inputs(CASES[name], seed=4)
    window, heads, shift = d["cfg"]
    x, w = d["x"] * 20.0, d["w"]
    dy = d["g"]
    jargs = [jnp.asarray(a) for a in (x, dy, d["m1"], w[0], w[1], w[2], w[3], w[4])]
    want = jw._attn_ln1_bwd_call(*jargs, d["jbias"], window, heads, shift, EPS)
    got = tw.attn_ln1_bwd_plain(*[torch.from_numpy(a) for a in (x, dy, d["m1"], w[0], w[1],
                                                                 w[2], w[3], w[4])],
                                d["tbias"], window, heads, shift, EPS)
    assert len(got) == len(want) == 8
    for n, a, b in zip(["dx", "dln1_s", "dln1_b", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b",
                        "dbias"], got, want):
        _close(a, b, n)
    # a dropped row (m1 = 0): the attention half adds nothing, dx = dy
    np.testing.assert_array_equal(got[0][1].numpy(), dy[1])


@pytest.mark.parametrize("name", ["w8-shift0", "w8-shift4", "w4-shift0"])
def test_window_attention_bwd_plain_matches_jax_kernel(name):
    d = _inputs(CASES[name], seed=5)
    window, heads, shift = d["cfg"]
    x, w = d["x"] * 20.0, d["w"]
    jargs = [jnp.asarray(a) for a in (x, d["g"], w[2], w[3], w[4], w[5])]
    want = jw._fused_window_attention_bwd(*jargs, d["jbias"], window, heads, shift)
    targs = [torch.from_numpy(a) for a in (x, d["g"], w[2], w[3], w[4], w[5])]
    got = tw.window_attention_bwd_plain(*targs, d["tbias"], window, heads, shift)
    for n, a, b in zip(["dx", "dqkv_w", "dqkv_b", "dproj_w", "dproj_b", "dbias"], got, want):
        _close(a, b, n)
    before = tw.window_attention_bwd.launches
    routed = tw.window_attention_bwd(*targs, d["tbias"], window, heads, shift)
    assert tw.window_attention_bwd.launches == before
    for a, b in zip(routed, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _grads(fn, leaves, g):
    leaves = [t.clone().requires_grad_() for t in leaves]
    return torch.autograd.grad(fn(*leaves), leaves, g)


@pytest.mark.parametrize("name", ["w8-shift4", "w4-shift0"])
def test_k3_k5_wrappers_carry_gradients(name):
    """``fused_window_attention`` (K5 forward, K6 backward) and
    ``fused_swin_block`` (K3 forward, autograd of the plain block backward)
    give the plain versions' gradients: autograd of ``window_attention_plain``
    and of ``swin_block_plain``."""
    d = _inputs(CASES[name], seed=6)
    window, heads, shift = d["cfg"]
    t = [torch.from_numpy(a) for a in [d["x"]] + d["w"]] + [d["tbias"]]
    g = torch.from_numpy(d["g"])
    cfg = (window, heads, shift)
    attn = [t[0]] + t[3:7] + [t[13]]
    got = _grads(lambda *a: tw.fused_window_attention(*a, *cfg), attn, g)
    want = _grads(lambda *a: tw.window_attention_plain(*a, *cfg), attn, g)
    for n, a, b in zip(["x", "qkv_w", "qkv_b", "proj_w", "proj_b", "bias"], got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=n)
    got = _grads(lambda *a: tw.fused_swin_block(*a, *cfg, EPS), t, g)
    want = _grads(lambda *a: tw.swin_block_plain(*a, *cfg, EPS), t, g)
    for n, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_bf16_plain_train_block_rounds_like_the_jax_kernels():
    """In bf16 the plain train block and its backward round at the JAX
    kernels' points; against the Pallas kernels (interpret mode, bf16) they
    stay within a few bf16 steps (2**-8 relative) of the largest entry."""
    d = _inputs(CASES["w8-shift4"], seed=7)
    window, heads, shift = d["cfg"]
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in [d["x"] * 20.0] + d["w"]]
    jm = [jnp.asarray(d["m1"]), jnp.asarray(d["m2"])]
    want, want_y = jw._fused_swin_block_train_fwd_only(*jx, d["jbias"], *jm, window, heads,
                                                       shift, EPS)
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in [d["x"] * 20.0] + d["w"]]
    tm = [torch.from_numpy(d["m1"]), torch.from_numpy(d["m2"])]
    got, got_y = tw.swin_block_train_plain(*tx, d["tbias"], *tm, window, heads, shift, EPS)
    assert got.dtype == torch.bfloat16
    for a, b in ((got, want), (got_y, want_y)):
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=2.0 ** -6 * np.abs(b).max())


def test_train_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, 8, 16, device="meta")
    m = torch.ones(2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tw.fused_swin_block_train(x, *[x] * 13, m, m, 4, 2, 0, 1e-6)
    for fn, args in ((tw.mlp_bwd, (x, x, m, x, x, x, x, x, 1e-6)),
                     (tw.attn_ln1_bwd, (x, x, m, x, x, x, x, x, x, 4, 2, 0, 1e-6)),
                     (tw.window_attention_bwd, (x, x, x, x, x, x, x, 4, 2, 0))):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*args)
