"""The PANNs CNN audio towers: Cnn10, Cnn14 and ResNet38.

The counterpart of the JAX package's ``models/cnns.py``: a BatchNorm over the
mel bins, optional spec augmentation, a stack of 3x3 conv + BN + ReLU blocks
with 2x2 average pooling and dropout 0.2, then a mean over mel and a max +
mean over time. ``Cnn10`` has 4 blocks (512-d), ``Cnn14`` 6 (2048-d);
``ResNet38`` is a ConvBlock stem, a ResNet-34 trunk of basic blocks
(``layers`` (3, 4, 6, 3); stride 2 is a leading 2x2 average pool, on the
identity branch too) and a 2048-wide ConvBlock without pooling.

Towers take spectrograms ``[B, T, F]`` and return clip features ``[B, C]``,
with HTSAT's calling convention (``models/htsat.py``): ``init(seed,
device)``, ``apply(variables, spec, train=False, generator=None)``, and in
train mode ``(features, new_batch_stats)``. Variables are the flax tree as
tensors: conv kernels HWIO, BatchNorm ``scale``/``bias`` with running
``mean``/``var``, so ``models.convert.from_jax_params`` carries JAX weights
across unchanged.

- BatchNorm is flax's (``batch_norm``): running statistics in eval; in train
  the batch's over every axis but the channel one, reduced in fp32 with the
  biased variance E[x^2] - E[x]^2, and the running update ``0.9 * old + 0.1
  * batch``. HTSAT's ``bn0`` uses the same function. In eval a conv block's
  BatchNorm is ``F.batch_norm`` on the running statistics: the same fp32
  arithmetic rounded once to ``dtype``, in one pass over the activations
  where ``batch_norm``'s fp32 temporaries take several.
- Activations are NCHW tensors in channels-last memory (the JAX layout,
  NHWC, which cuDNN's bf16 tensor-core convolutions take); each call
  permutes the HWIO kernels to OIHW and casts them to ``dtype``. Compute
  runs in ``dtype`` over fp32 parameters; BN statistics stay fp32.
- Pooling floors odd sizes, as flax's VALID pooling does.
- Dropout keeps an entry with probability 1 - rate and scales it by
  1 / (1 - rate), as flax does. Its draws, and spec augmentation's, come from
  the caller's ``torch.Generator`` in a fixed order (augmentation, then each
  dropout in forward order); they are not JAX's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from zs_aac_tpu_torch.ops.specaug import spec_augment
from zs_aac_tpu_torch.parallel.mesh import mean_over
from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = ["batch_norm", "Cnn10", "Cnn14", "ResNet38"]

_BN_EPS = 1e-5


def batch_norm(x, p, stats, train: bool, axis: int = -1, data=None):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    ``axis`` of ``x``: (the output in fp32, the new running statistics in
    train mode or None). ``p`` holds ``scale``/``bias``, ``stats``
    ``mean``/``var``. Under ``data`` (a ``parallel.mesh.Axis``; ``x`` this
    rank's rows) E[x] and E[x^2] are means over the ranks, gradient
    included, so the statistics are the global batch's."""
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    view = lambda t: t.float().reshape(shape)
    xf = x.float()
    new = None
    if train:
        dims = [d for d in range(x.dim()) if d != axis]
        mean, sq = mean_over(torch.stack([xf.mean(dim=dims), (xf * xf).mean(dim=dims)]), data)
        var = torch.clamp_min(sq - mean * mean, 0.0)
        with torch.no_grad():
            new = {"mean": 0.9 * stats["mean"] + 0.1 * mean.detach(),
                   "var": 0.9 * stats["var"] + 0.1 * var.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
    mul = torch.rsqrt(view(var) + _BN_EPS) * view(p["scale"])
    return (xf - view(mean)) * mul + view(p["bias"]), new


def _conv(x, kernel, dt):
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=dt)`` on an NCHW
    channels-last ``x``; ``kernel`` HWIO (3x3 or 1x1, stride 1)."""
    w = kernel.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, padding=kernel.shape[0] // 2)


def _avg_pool2(x):
    """flax ``avg_pool((2, 2), strides=(2, 2))`` (VALID: odd sizes floor) of an
    NCHW channels-last ``x``: the mean over the window axes of its NHWC view,
    an fp32 sum rounded once as ``F.avg_pool2d`` rounds it, whose own
    channels-last kernel is the slower on the card (``chip_smoke.py`` phase
    16's profile)."""
    B, C, H, W = x.shape
    h, w = H // 2, W // 2
    nhwc = x.permute(0, 2, 3, 1)[:, :2 * h, :2 * w]
    return nhwc.reshape(B, h, 2, w, 2, C).mean(dim=(2, 4)).permute(0, 3, 1, 2)


class _Run:
    """One forward pass: the variables, the mode, the random draws and the
    new batch statistics it collects (a tree like ``batch_stats``)."""

    def __init__(self, variables, dt, train: bool, dropout_rate: float, generator, data=None):
        self.p, self.st = variables["params"], variables["batch_stats"]
        self.dt, self.train, self.rate, self.g = dt, train, dropout_rate, generator
        self.data = data
        self.new_stats = {}

    def bn(self, x, path, relu=False):
        p, st = self.p, self.st
        for k in path:
            p, st = p[k], st[k]
        if not self.train:
            # the running statistics: one pass that computes in fp32 and rounds
            # to x's dtype once (batch_norm's arithmetic up to association)
            y = F.batch_norm(x, st["mean"].float(), st["var"].float(), p["scale"].float(),
                             p["bias"].float(), False, 0.0, _BN_EPS)
            return F.relu(y, inplace=True) if relu else y
        y, new = batch_norm(x, p, st, True, axis=1, data=self.data)
        node = self.new_stats
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = new
        return (F.relu(y) if relu else y).to(self.dt)

    def conv(self, x, path):
        p = self.p
        for k in path:
            p = p[k]
        return _conv(x, p["kernel"], self.dt)

    def conv_block(self, x, name, pool=True):
        """``ConvBlock``: (3x3 conv, BN, ReLU) twice, then a 2x2 average pool."""
        for i in (1, 2):
            x = self.bn(self.conv(x, (name, f"conv{i}")), (name, f"bn{i}"), relu=True)
        return _avg_pool2(x) if pool else x

    def dropout(self, x):
        if not self.train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        B, C, H, W = x.shape
        n = B * (self.data.size if self.data else 1)    # drawn for the global batch
        u = torch.rand(n, H, W, C, generator=self.g, device=self.g.device)
        u = (self.data.local(u) if self.data else u).permute(0, 3, 1, 2)
        return torch.where(u.to(x.device) < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))

    def stem(self, spec, spec_augmentation: bool):
        """``bn0`` over the mel bins of ``[B, T, F]``, spec augmentation in
        train mode -> ``[B, 1, T, F]`` channels-last in ``dt``."""
        x, new = batch_norm(spec, self.p["bn0"], self.st["bn0"], self.train, axis=-1,
                            data=self.data)
        if new is not None:
            self.new_stats["bn0"] = new
        x = x.to(self.dt)
        if self.train and spec_augmentation:
            x = spec_augment(x, self.g, data=self.data)
        return x[:, None].contiguous(memory_format=torch.channels_last)

    def result(self, x):
        """Mean over mel, then max + mean over time: ``[B, C, T, F] -> [B, C]``."""
        x = x.mean(dim=3)
        x = x.amax(dim=2) + x.mean(dim=2)
        return (x, self.new_stats) if self.train else x


def _check_generator(tower, train: bool, generator):
    if train and (tower.spec_augmentation or tower.dropout_rate > 0) and generator is None:
        raise ValueError(f"{type(tower).__name__} train mode with spec augmentation or dropout "
                         "needs a torch.Generator")


class _Init:
    """Seeded variables in the flax tree (LeCun-normal kernels, unit BN
    scales and variances, zero biases and means)."""

    def __init__(self, seed: int, device):
        self.dev = resolve_device(device)
        self.g = torch.Generator().manual_seed(seed)
        self.params, self.stats = {}, {}

    def bn(self, path, c):
        p, s = self.params, self.stats
        for k in path[:-1]:
            p, s = p.setdefault(k, {}), s.setdefault(k, {})
        p[path[-1]] = {"scale": torch.ones(c, device=self.dev),
                       "bias": torch.zeros(c, device=self.dev)}
        s[path[-1]] = {"mean": torch.zeros(c, device=self.dev),
                       "var": torch.ones(c, device=self.dev)}

    def conv(self, path, k, cin, cout):
        p = self.params
        for key in path[:-1]:
            p = p.setdefault(key, {})
        w = torch.randn(k, k, cin, cout, generator=self.g) * (k * k * cin) ** -0.5
        p[path[-1]] = {"kernel": w.to(self.dev)}

    def conv_block(self, name, cin, cout):
        for i, c in ((1, cin), (2, cout)):
            self.conv((name, f"conv{i}"), 3, c, cout)
            self.bn((name, f"bn{i}"), cout)

    def variables(self):
        return {"params": self.params, "batch_stats": self.stats}


@dataclasses.dataclass(frozen=True)
class _CnnBase:
    """Cnn10/Cnn14: conv blocks + dropout + clip pooling. ``n_mels`` is the
    input's mel count (the width of ``bn0``, which ``init`` needs)."""

    channels: Sequence[int] = ()
    spec_augmentation: bool = True
    dropout_rate: float = 0.2
    n_mels: int = 64
    dtype: Any = torch.float32

    @property
    def num_features(self) -> int:
        return int(self.channels[-1])

    def init(self, seed: int = 0, device="cuda") -> dict:
        ini = _Init(seed, device)
        ini.bn(("bn0",), self.n_mels)
        cin = 1
        for i, ch in enumerate(self.channels):
            ini.conv_block(f"conv_block{i + 1}", cin, ch)
            cin = ch
        return ini.variables()

    def apply(self, variables, spec, *, train: bool = False,
              generator: Optional[torch.Generator] = None, data=None):
        """``spec`` [B, T, F] -> features [B, C] (``(features,
        new_batch_stats)`` with ``train``, its draws from ``generator``).
        Under ``data`` (``parallel.mesh.Axis``) ``spec`` is this rank's rows:
        batch statistics are the global batch's, and the draws are made for
        the global batch and sliced."""
        _check_generator(self, train, generator)
        run = _Run(variables, self.dtype, train, self.dropout_rate, generator, data)
        x = run.stem(spec, self.spec_augmentation)
        for i in range(len(self.channels)):
            x = run.dropout(run.conv_block(x, f"conv_block{i + 1}"))
        return run.result(x)


@dataclasses.dataclass(frozen=True)
class Cnn10(_CnnBase):
    channels: Sequence[int] = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class Cnn14(_CnnBase):
    channels: Sequence[int] = (64, 128, 256, 512, 1024, 2048)


def _resnet_blocks(layers):
    """(name, planes, in_planes, stride, downsample) of each basic block."""
    in_planes = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        for b in range(blocks):
            s = (1 if stage == 0 else 2) if b == 0 else 1
            ds = b == 0 and (s != 1 or in_planes != planes)
            yield f"layer{stage + 1}_block{b}", planes, in_planes, s, ds
            in_planes = planes


@dataclasses.dataclass(frozen=True)
class ResNet38:
    """PANNs ResNet38: ConvBlock stem, ResNet-34 trunk ``layers``, 2048-d head."""

    spec_augmentation: bool = True
    dropout_rate: float = 0.2
    layers: Sequence[int] = (3, 4, 6, 3)
    n_mels: int = 64
    dtype: Any = torch.float32

    num_features = 2048

    def init(self, seed: int = 0, device="cuda") -> dict:
        ini = _Init(seed, device)
        ini.bn(("bn0",), self.n_mels)
        ini.conv_block("conv_block1", 1, 64)
        for name, planes, cin, _, ds in _resnet_blocks(self.layers):
            ini.conv((name, "conv1"), 3, cin, planes)
            ini.bn((name, "bn1"), planes)
            ini.conv((name, "conv2"), 3, planes, planes)
            ini.bn((name, "bn2"), planes)
            if ds:
                ini.conv((name, "ds_conv"), 1, cin, planes)
                ini.bn((name, "ds_bn"), planes)
        ini.conv_block("conv_block_after1", 512, 2048)
        return ini.variables()

    def apply(self, variables, spec, *, train: bool = False,
              generator: Optional[torch.Generator] = None, data=None):
        """``spec`` [B, T, F] -> features [B, 2048] (as ``Cnn14.apply``)."""
        _check_generator(self, train, generator)
        run = _Run(variables, self.dtype, train, self.dropout_rate, generator, data)
        x = run.stem(spec, self.spec_augmentation)
        x = run.dropout(run.conv_block(x, "conv_block1"))
        for name, _, _, stride, ds in _resnet_blocks(self.layers):
            identity = x
            out = _avg_pool2(x) if stride == 2 else x
            out = run.dropout(run.bn(run.conv(out, (name, "conv1")), (name, "bn1"), relu=True))
            out = run.bn(run.conv(out, (name, "conv2")), (name, "bn2"))
            if ds:
                if stride == 2:
                    identity = _avg_pool2(identity)
                identity = run.bn(run.conv(identity, (name, "ds_conv")), (name, "ds_bn"))
            x = F.relu(out + identity)
        x = run.dropout(_avg_pool2(x))
        x = run.dropout(run.conv_block(x, "conv_block_after1", pool=False))
        return run.result(x)
