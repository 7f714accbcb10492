"""The port's HTSAT in train mode against the JAX package's.

At the geometry of ``tests/test_htsat.py::test_fused_swin_block_train_grad_
matches_xla`` (drop path 0, spec augmentation off, so both sides are
deterministic), seeded JAX variables go to the port through
``from_jax_params``; the gradient of ``sum(tanh(embedding))`` with respect to
every parameter leaf and the new ``batch_stats`` must match ``jax.grad`` of
the JAX model's layered XLA path, for the port's layered, ``fused_attn``
(K5/K6) and ``fused_block=(0,)`` + ``fused_attn`` (K7/K8/K9 in stage 0)
dispatches, at rtol 3e-3 / atol 1e-4 (the JAX package's own tolerance for
this comparison; fp32, summation order through a two-stage Swin).

Spec augmentation and drop path: masks built from given widths, starts and
uniforms equal the JAX package's formulas; the generator's draws have the
expected statistics; one seed gives the plain and the dispatched paths the
same masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zs_aac_tpu.models.htsat import HTSAT as JaxHTSAT
from zs_aac_tpu.ops.specaug import _stripe_mask as jax_stripe_mask
from zs_aac_tpu_torch.models.convert import from_jax_params, tree_map
from zs_aac_tpu_torch.models.htsat import HTSAT, drop_path_scale
from zs_aac_tpu_torch.ops import specaug

torch.set_num_threads(2)

GEO = dict(spec_size=64, patch_stride=4, patch_size=4, embed_dim=32, depths=(2, 2),
           num_heads=(2, 4), window_size=4, n_mels=16, drop_path_rate=0.0)
DISPATCH = {"layered": {}, "fused_attn": {"fused_attn": True},
            "fused_block0": {"fused_attn": True, "fused_block": (0,)}}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def jax_reference():
    rng = np.random.default_rng(5)
    spec = rng.standard_normal((2, 251, 16)).astype(np.float32)
    ref = JaxHTSAT(**GEO, spec_augmentation=False)
    variables = jax.jit(lambda r, s: ref.init({"params": r}, s, train=False))(
        jax.random.key(1), jnp.asarray(spec))
    # non-trivial running statistics, so the update's momentum is visible
    variables = {"params": variables["params"],
                 "batch_stats": {"bn0": {"mean": jnp.asarray(rng.standard_normal(16) * 0.1,
                                                             jnp.float32),
                                         "var": jnp.asarray(1 + rng.random(16), jnp.float32)}}}

    def loss(params):
        out, new = ref.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(spec), train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.key(7),
                                   "specaug": jax.random.key(8)})
        return jnp.sum(jnp.tanh(out)), new["batch_stats"]

    (value, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return {"spec": spec, "variables": as_np(variables), "value": float(value),
            "grads": as_np(grads), "stats": as_np(stats)}


@pytest.mark.parametrize("dispatch", sorted(DISPATCH))
def test_train_gradients_and_batch_stats_match_jax(jax_reference, dispatch):
    variables = from_jax_params(jax_reference["variables"], device="cpu")
    params = tree_map(lambda t: t.clone().requires_grad_(), variables["params"])
    model = HTSAT(**GEO, spec_augmentation=False, **DISPATCH[dispatch])
    out, stats = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             torch.from_numpy(jax_reference["spec"]), train=True)
    value = torch.tanh(out).sum()
    names, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    want = dict(_leaves(jax_reference["grads"]))
    assert sorted(names) == sorted(want)
    np.testing.assert_allclose(value.item(), jax_reference["value"], rtol=1e-5)
    for n, g in zip(names, grads):
        g = np.zeros_like(want[n]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[n], rtol=3e-3, atol=1e-4, err_msg=n)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats["bn0"][k].numpy(), jax_reference["stats"]["bn0"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_stripe_mask_matches_jax_formula():
    """JAX's ``_stripe_mask`` draws widths and starts from a key; the port's
    ``stripe_mask`` of the same widths and starts gives the same mask."""
    for b, size, width, n in ((6, 251, 64, 2), (5, 16, 8, 2), (3, 20, 30, 3)):
        key = jax.random.key(size + n)
        want = np.asarray(jax_stripe_mask(key, b, size, width, n))
        kw, ks = jax.random.split(key)
        widths = jax.random.randint(kw, (b, n), 0, width)
        starts = jax.random.randint(ks, (b, n), 0, jnp.maximum(size - widths, 1))
        got = specaug.stripe_mask(torch.from_numpy(np.array(widths)).long(),
                                  torch.from_numpy(np.array(starts)).long(), size)
        np.testing.assert_array_equal(got.numpy(), want)


def test_drop_path_scale_matches_jax_formula():
    """bernoulli(keep) / keep: JAX's bernoulli is ``uniform < keep``."""
    key = jax.random.key(3)
    keep = 0.9
    u = np.asarray(jax.random.uniform(key, (4096,)))
    want = np.asarray(jax.random.bernoulli(key, keep, (4096,)).astype(jnp.float32) / keep)
    np.testing.assert_array_equal(drop_path_scale(torch.from_numpy(u), keep).numpy(), want)


def test_generator_draws_have_the_expected_statistics():
    g = torch.Generator().manual_seed(0)
    widths, starts = specaug._draw(g, 20000, 251, 64, 2)
    assert widths.min() == 0 and widths.max() == 63
    assert abs(widths.float().mean().item() - 31.5) < 0.5          # uniform on 0..63
    assert starts.min() == 0 and bool((starts + widths <= 251).all())
    assert bool((starts < torch.clamp(251 - widths, min=1)).all())
    # the fraction of zeroed time frames: E[union of 2 stripes of mean width 31.5] / 251
    x = torch.ones(4000, 251, 16)
    zeroed = (specaug.spec_augment(x, torch.Generator().manual_seed(1)) == 0)
    frac_t = zeroed.all(dim=2).float().mean().item()
    assert 0.20 < frac_t < 0.26
    m = HTSAT(**{**GEO, "drop_path_rate": 0.5})._keep_scales(torch.Generator().manual_seed(2),
                                                             20000, "cpu")
    assert m[0] is None and len(m) == 4
    kept = m[-1][0].eq(2.0).float().mean().item()                   # rate 0.5: keep 1/2
    assert abs(kept - 0.5) < 0.02
    assert set(m[-1][1].unique().tolist()) <= {0.0, 2.0}
    assert abs(m[1][0].eq(1 / (1 - 0.5 / 3)).float().mean().item() - (1 - 0.5 / 3)) < 0.02


def test_one_seed_gives_every_dispatch_the_same_masks():
    """Spec augmentation on and drop path 0.3: the layered plain path and
    the train-kernel dispatch, each fed a generator of one seed, agree (fp32,
    summation order only), gradients included; another seed does not."""
    geo = {**GEO, "drop_path_rate": 0.3}
    variables = HTSAT(**geo).init(seed=0, device="cpu")
    spec = torch.randn(3, 251, 16, generator=torch.Generator().manual_seed(4))
    res = {}
    for name, flags, seed in (("plain", {}, 11), ("fused", DISPATCH["fused_block0"], 11),
                              ("other-seed", {}, 12)):
        params = tree_map(lambda t: t.clone().requires_grad_(), variables["params"])
        out, _ = HTSAT(**geo, **flags).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, spec, train=True,
            generator=torch.Generator().manual_seed(seed))
        grad = torch.autograd.grad(out.square().sum(),
                                   params["layer0_block1"]["fc1"]["kernel"])[0]
        res[name] = (out.detach(), grad)
    for a, b in zip(res["plain"], res["fused"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert not torch.allclose(res["plain"][0], res["other-seed"][0], atol=1e-3)


def test_train_mode_needs_a_generator():
    variables = HTSAT(**GEO).init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        HTSAT(**GEO).apply(variables, torch.zeros(2, 100, 16), train=True)
