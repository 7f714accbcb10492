"""The port's HTSAT against the JAX package's on the same weights.

Real random weights in the reference checkpoint's layout (the torch twin of
``tests/test_htsat.py``) reach both packages: the JAX package through its
``convert_htsat``, the port both natively (its own ``convert_htsat``) and
through ``from_jax_params`` of the JAX variables. The JAX model runs its XLA
path and its fused Pallas path (interpret mode on the CPU); the port runs
its plain path and every fused flag set (the kernels' plain versions on the
CPU). All four ``return_dict`` outputs must agree at rtol/atol 2e-4 (fp32,
summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_htsat import TINY, TorchHTSAT, _randomize_torch_htsat
from zs_aac_tpu.models import htsat as jh
from zs_aac_tpu.models.convert import convert_htsat as jax_convert_htsat
from zs_aac_tpu_torch.models import htsat as th
from zs_aac_tpu_torch.models.convert import convert_htsat, from_jax_params

torch.set_num_threads(2)

FLAGS = {"plain": {}, "fused_attn": {"fused_attn": True},
         "fused_block": {"fused_attn": True, "fused_block": True},
         "card_dispatch": {"fused_attn": True, "fused_block": (0,)}}


@pytest.fixture(scope="module")
def golden():
    torch.manual_seed(0)
    rng = np.random.default_rng(42)
    tm = TorchHTSAT()
    _randomize_torch_htsat(tm, rng)
    tm.eval()
    spec = rng.standard_normal((2, 100, 16)).astype(np.float32)
    variables = jax.tree.map(jnp.asarray, jax_convert_htsat(tm.state_dict(),
                                                            depths=TINY["depths"]))
    want = {}
    for name, fl in (("xla", {}), ("pallas", {"fused_attn": True, "fused_block": True})):
        model = jh.HTSAT(**TINY, **fl)
        out = jax.jit(lambda v, s: model.apply(v, s, train=False, return_dict=True))(
            variables, jnp.asarray(spec))
        want[name] = {k: np.asarray(v) for k, v in out.items()}
    return {"state_dict": tm.state_dict(), "jax_vars": jax.tree.map(np.asarray, variables),
            "spec": spec, "want": want}


@pytest.mark.parametrize("route", ["native", "from_jax_params"])
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_htsat_matches_jax(golden, flags, route):
    if route == "native":
        variables = convert_htsat(golden["state_dict"], device="cpu")
    else:
        variables = from_jax_params(golden["jax_vars"], device="cpu")
    model = th.HTSAT(**TINY, **FLAGS[flags])
    got = model.apply(variables, torch.from_numpy(golden["spec"]), return_dict=True)
    emb = model.apply(variables, torch.from_numpy(golden["spec"]))
    torch.testing.assert_close(emb, got["embedding"], rtol=0, atol=0)
    for jax_path, want in golden["want"].items():
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"{k} vs JAX {jax_path}")


def test_convert_htsat_tree_matches_jax(golden):
    """Same leaves, same layouts as the JAX converter (depths inferred)."""
    got = convert_htsat(golden["state_dict"], device="cpu")
    want = golden["jax_vars"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got)))
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=jax.tree_util.keystr(k))


def test_init_tree_matches_jax_init():
    """The seeded init has the JAX init's tree, shapes and dtypes."""
    model = jh.HTSAT(**TINY)
    spec = jnp.zeros((1, 100, 16))
    ref = jax.jit(lambda r, s: model.init({"params": r}, s, train=False, return_dict=True))(
        jax.random.key(0), spec)
    got = th.HTSAT(**TINY).init(seed=0, device="cpu")
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))
                           for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert shapes(jax.tree.map(lambda t: t.numpy(), got)) == shapes(ref)


@pytest.mark.parametrize("t_in,t_out", [(101, 256), (1001, 1024), (64, 64)])
def test_constants_match_jax(t_in, t_out):
    np.testing.assert_array_equal(th.bicubic_resize_matrix(t_in, t_out),
                                  jh.bicubic_resize_matrix(t_in, t_out))
    np.testing.assert_array_equal(th._relative_position_index(8, 8),
                                  jh._relative_position_index(8, 8))
    for shift in (0, 2, 4):
        a, b = th._shift_attn_mask(16, 16, 8, shift), jh._shift_attn_mask(16, 16, 8, shift)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_window_partition_roundtrip():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 16, 8)).astype(
        np.float32))
    w = th._window_partition(x, 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jh._window_partition(
        jnp.asarray(x.numpy()), 4)))
    torch.testing.assert_close(th._window_reverse(w, 4, 16, 16), x, rtol=0, atol=0)


def test_training_waits_for_a_later_slice():
    model = th.HTSAT(**TINY)
    variables = model.init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        model.apply(variables, torch.zeros(1, 100, 16), train=True)
