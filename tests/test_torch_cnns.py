"""The port's PANNs towers (``models/cnns.py``) and their converters against
the JAX package's, on the same numpy weights (JAX init, BatchNorm affine and
running statistics randomized as ``tests/test_cnns.py`` randomizes them) and
the same seeded spectrograms with odd sizes.

Tolerances (fp32, summation order only): features and new batch statistics
1e-4 relative and absolute, the bound of the JAX package's own golden test
(``tests/test_cnns.py``); gradients 1e-4 relative and 1e-4 of the leaf's
largest entry absolute (an entry of a BN scale's gradient sums ~25,000
products that can cancel, so a small entry carries the rounding of large
ones: ResNet38's reach 1e-5 of the leaf's largest). Converted variables are
bitwise equal.
Dropout: over 262,144 entries the kept share lies within 0.01 of 0.8 (25
standard deviations), and every kept entry is exactly 1 / 0.8.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

import jax
import jax.numpy as jnp

from test_cnns import _TorchConvBlock, _TorchMiniCnn
from zs_aac_tpu.models import cnns as jcnns
from zs_aac_tpu.models import convert as jconvert
from zs_aac_tpu_torch.models import cnns
from zs_aac_tpu_torch.models.convert import convert_cnn, convert_resnet38, from_jax_params

torch.set_num_threads(2)

TOL = 1e-4

# name -> (JAX class, port class, their kwargs, spectrogram [B, T, F])
TOWERS = {
    "cnn10": (jcnns.Cnn10, cnns.Cnn10, {}, (2, 35, 16)),
    "cnn14_2": (jcnns.Cnn14, cnns.Cnn14, {"channels": (4, 8)}, (3, 37, 16)),
    "cnn14_3": (jcnns.Cnn14, cnns.Cnn14, {"channels": (8, 16, 32)}, (2, 45, 24)),
    "resnet38": (jcnns.ResNet38, cnns.ResNet38, {"layers": (1, 1, 1, 1)}, (3, 130, 64)),
}
# ResNet38 pools five times: at 130 x 64 its last BatchNorm sees 4 x 2 positions
# a clip, 24 samples a channel in train mode. (At 41 x 32 it sees one position,
# 2 samples: batch variances near 0 make the train-mode output hinge on the
# last bits of E[x^2] - E[x]^2, in either package.)


def _randomize(variables, seed):
    """BatchNorm scales near 1, biases and means around 0, variances in
    [0.5, 2] (``tests/test_cnns.py``'s statistics), kernels as initialized."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, variables))
    out = []
    for path, v in flat[0]:
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            v = (1.0 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        elif "bias" in name:
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif "mean" in name:
            v = rng.standard_normal(v.shape).astype(np.float32)
        elif "var" in name:
            v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        out.append(np.asarray(v))
    return jax.tree_util.tree_unflatten(flat[1], out)


def _case(name, dropout_rate=0.2):
    jcls, tcls, kw, shape = TOWERS[name]
    jm = jcls(spec_augmentation=False, dropout_rate=dropout_rate, **kw)
    spec = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    variables = _randomize(jax.jit(lambda k: jm.init({"params": k}, jnp.asarray(spec),
                                                     train=False))(jax.random.key(0)), 2)
    tm = tcls(spec_augmentation=False, dropout_rate=dropout_rate, n_mels=shape[2], **kw)
    return jm, tm, variables, spec


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _np(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_init_tree_matches_jax(name):
    jm, tm, variables, _ = _case(name)
    shapes = lambda tree: {k: v.shape for k, v in _flat(tree).items()}
    assert shapes(_np(tm.init(0, device="cpu"))) == shapes(variables)
    assert tm.num_features == {"cnn10": 512, "cnn14_2": 8, "cnn14_3": 32, "resnet38": 2048}[name]


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_eval_features_match_jax(name):
    jm, tm, variables, spec = _case(name)
    want = np.asarray(jm.apply(variables, jnp.asarray(spec), train=False))
    got = tm.apply(from_jax_params(variables, device="cpu"), torch.from_numpy(spec))
    assert got.shape == want.shape == (spec.shape[0], tm.num_features)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_train_mode_matches_jax(name):
    """Train mode at dropout 0, no spec augmentation: the features, every
    BN's new running statistics, and the parameter gradients of a fixed
    cotangent."""
    jm, tm, variables, spec = _case(name, dropout_rate=0.0)
    cot = np.random.default_rng(5).standard_normal((spec.shape[0], tm.num_features))
    cot = cot.astype(np.float32)

    def jloss(params):
        out, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(spec), train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mutated["batch_stats"])

    (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tv = from_jax_params(variables, device="cpu")
    params = jax.tree.map(lambda t: t.requires_grad_(), tv["params"],
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    got, stats = tm.apply({"params": params, "batch_stats": tv["batch_stats"]},
                          torch.from_numpy(spec), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    got_s, want_s = _flat(_np(stats)), _flat(want_stats)
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=TOL, atol=TOL, err_msg=k)
    (got * torch.from_numpy(cot)).sum().backward()
    got_g = _flat(jax.tree.map(lambda t: t.grad.numpy(), params,
                               is_leaf=lambda t: isinstance(t, torch.Tensor)))
    want_g = _flat(want_grads)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], rtol=TOL,
                                   atol=TOL * np.abs(want_g[k]).max(), err_msg=k)


# --- converters: torch re-implementations of the reference blocks -----------


class _TorchResBlock(tnn.Module):
    """The reference's ``_ResnetBasicBlock`` (eval: no dropout): stride 2 as
    a leading 2x2 average pool; its downsample ``(conv, bn)``, or ``(AvgPool,
    conv, bn)`` at stride 2."""

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.stride = stride
        self.conv1 = tnn.Conv2d(cin, planes, 3, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = None
        if stride == 2:
            self.downsample = tnn.Sequential(tnn.AvgPool2d(2), tnn.Conv2d(cin, planes, 1,
                                                                          bias=False),
                                             tnn.BatchNorm2d(planes))
        elif cin != planes:
            self.downsample = tnn.Sequential(tnn.Conv2d(cin, planes, 1, bias=False),
                                             tnn.BatchNorm2d(planes))

    def forward(self, x):
        out = tF.avg_pool2d(x, 2) if self.stride == 2 else x
        out = self.bn2(self.conv2(tF.relu(self.bn1(self.conv1(out)))))
        identity = x if self.downsample is None else self.downsample(x)
        return tF.relu(out + identity)


class _TorchResNet38(tnn.Module):
    """The reference ResNet38's layout (``bn0``, ``conv_block1``,
    ``resnet.layer{i}.{b}``, ``conv_block_after1``, and the ``fc`` head and
    extractor keys the converters skip)."""

    def __init__(self, layers, n_mels):
        super().__init__()
        self.bn0 = tnn.BatchNorm2d(n_mels)
        self.conv_block1 = _TorchConvBlock(1, 64)
        self.resnet = tnn.Module()
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = [_TorchResBlock(cin if b == 0 else planes, planes,
                                     (1 if i == 0 else 2) if b == 0 else 1) for b in range(n)]
            setattr(self.resnet, f"layer{i + 1}", tnn.Sequential(*blocks))
            cin = planes
        self.conv_block_after1 = _TorchConvBlock(512, 2048)
        self.fc1 = tnn.Linear(2048, 2048)
        self.layers = layers

    def forward(self, spec):  # [B, 1, T, F]
        x = self.bn0(spec.transpose(1, 3)).transpose(1, 3)
        x = self.conv_block1(x)
        for i in range(len(self.layers)):
            x = getattr(self.resnet, f"layer{i + 1}")(x)
        x = tF.avg_pool2d(x, 2)
        b = self.conv_block_after1
        x = tF.relu(b.bn2(b.conv2(tF.relu(b.bn1(b.conv1(x))))))
        x = x.mean(dim=3)
        return x.amax(dim=2) + x.mean(dim=2)


def _randomize_torch(m, seed):
    rng = np.random.default_rng(seed)
    for mod in m.modules():
        if isinstance(mod, tnn.BatchNorm2d):
            n = mod.num_features
            f = lambda a: torch.tensor(a, dtype=torch.float32)
            mod.weight.data = f(1.0 + 0.2 * rng.standard_normal(n))
            mod.bias.data = f(0.1 * rng.standard_normal(n))
            mod.running_mean.data = f(rng.standard_normal(n))
            mod.running_var.data = f(rng.uniform(0.5, 2.0, n))


@pytest.mark.parametrize("kind", ["cnn", "resnet38"])
def test_converters_match_jax_and_the_torch_module(kind):
    torch.manual_seed(0)
    if kind == "cnn":
        channels = (8, 16)
        ref, shape = _TorchMiniCnn(channels), (2, 29, 16)
        tower = cnns.Cnn14(channels=channels, spec_augmentation=False, n_mels=16)
    else:
        ref, shape = _TorchResNet38((1, 2, 1, 1), 32), (2, 37, 32)
        tower = cnns.ResNet38(layers=(1, 2, 1, 1), spec_augmentation=False, n_mels=32)
    ref = ref.eval()
    _randomize_torch(ref, 3)
    sd = dict(ref.state_dict())
    sd["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(3)   # skipped
    sd["logmel_extractor.melW"] = torch.zeros(3)                          # skipped
    if kind == "cnn":
        sd["fc1.weight"] = torch.zeros(4, 4)
        got = convert_cnn(sd, n_blocks=2, device="cpu")
        want = jconvert.convert_cnn(sd, n_blocks=2)
    else:
        got = convert_resnet38(sd, layers=(1, 2, 1, 1), device="cpu")
        want = jconvert.convert_resnet38(sd, layers=(1, 2, 1, 1))
    got_f, want_f = _flat(_np(got)), _flat(want)
    assert sorted(got_f) == sorted(want_f)
    for k in want_f:
        np.testing.assert_array_equal(got_f[k], want_f[k], err_msg=k)
    spec = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        expect = ref(torch.from_numpy(spec)[:, None]).numpy()
    feats = tower.apply(got, torch.from_numpy(spec))
    np.testing.assert_allclose(feats.numpy(), expect, rtol=TOL, atol=TOL)


def test_dropout_keeps_its_share_and_scales_kept_entries():
    run = cnns._Run({"params": {}, "batch_stats": {}}, torch.float32, True, 0.2,
                    torch.Generator().manual_seed(0))
    x = torch.ones(4, 16, 64, 64).contiguous(memory_format=torch.channels_last)
    y = run.dropout(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    assert bool((y[kept] == 1.25).all())
    assert y.is_contiguous(memory_format=torch.channels_last)
    again = cnns._Run({"params": {}, "batch_stats": {}}, torch.float32, True, 0.2,
                      torch.Generator().manual_seed(0)).dropout(x)
    assert torch.equal(y, again)
    assert torch.equal(cnns._Run({"params": {}, "batch_stats": {}}, torch.float32, False, 0.2,
                                 None).dropout(x), x)


def test_train_mode_draws_from_the_generator():
    """Spec augmentation and dropout in train mode: one seed gives one
    result, another seed another; without a generator the tower refuses."""
    tower = cnns.Cnn14(channels=(4, 8), n_mels=16)
    variables = tower.init(0, device="cpu")
    spec = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 70, 16))
                            .astype(np.float32))
    run = lambda seed: tower.apply(variables, spec, train=True,
                                   generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        tower.apply(variables, spec, train=True)


def test_pooling_floors_odd_sizes():
    """A 10 s clip's 1001 frames through six blocks (1001 -> 500 -> 250 ->
    125 -> 62 -> 31 -> 15 frames) give JAX's features."""
    tower = cnns.Cnn14(channels=(2, 2, 2, 2, 2, 4), n_mels=64, spec_augmentation=False)
    spec = torch.randn(1, 1001, 64)
    out = tower.apply(tower.init(0, device="cpu"), spec)
    assert out.shape == (1, 4) and bool(torch.isfinite(out).all())
    jm = jcnns.Cnn14(channels=(2, 2, 2, 2, 2, 4), spec_augmentation=False)
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 1001, 64)),
                                         train=False))
    want = np.asarray(jm.apply(v, jnp.asarray(spec.numpy()), train=False))
    np.testing.assert_allclose(tower.apply(from_jax_params(v, device="cpu"), spec).numpy(), want,
                               rtol=TOL, atol=TOL)
