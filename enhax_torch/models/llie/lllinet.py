"""LLLiNet: a UNet++-style supervised low-light net with a learnable-ratio
instance norm and SimAM attention, in RGB (``lllinet``) or HVI space
(``lllinet_hvi``).

Port of ``enhax/models/llie/lllinet.py``. Each ``UNetConvBlock`` runs conv
-> ``LearnableInstanceNorm`` (x_norm * r + x * (1 - r); none in the stem)
-> LeakyReLU(0.2) -> SimAM -> conv, concatenates a 1x1 shortcut of its
input, two more 3x3 convs, and adds a 1x1 of the concat. Inner nodes also
take the bilinear (align_corners) upsample of the level below's earlier
columns. The module holds NCHW maps; in and out NHWC. Parameter names are
the reference's (``conv{i}_{j}``, ``trans.density_k``), so a released
``.pth`` loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d
from enhax_torch.ops.color import hvi_to_rgb, rgb_to_hvi

_FILTERS = (32, 64, 128, 256, 512)


class LearnableInstanceNorm(nn.Module):
    """Instance norm (biased variance over H and W, eps 1e-5, affine)
    blended with its input by a learnable per-channel ratio ``r``."""

    def __init__(self, channels: int, r_init: float = 0.5, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.r = nn.Parameter(torch.full((channels,), r_init))
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = x.var(dim=(-2, -1), keepdim=True, correction=0)
        xn = (x - mean) * torch.rsqrt(var + self.eps) * self.weight[:, None, None] \
            + self.bias[:, None, None]
        r = self.r[:, None, None]
        return xn * r + x * (1.0 - r)


def simam(x: torch.Tensor, e_lambda: float = 1e-4) -> torch.Tensor:
    """SimAM attention on an NCHW map (no parameters)."""
    n = x.shape[-2] * x.shape[-1] - 1
    d = (x - x.mean(dim=(-2, -1), keepdim=True)) ** 2
    v = d.sum(dim=(-2, -1), keepdim=True) / n
    return x * torch.sigmoid(d / (4.0 * (v + e_lambda)) + 0.5)


class UNetConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, relu_slope: float = 0.2,
                 use_in: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        c, g = in_channels, generator
        self.relu_slope = relu_slope
        self.conv1 = flax_conv2d(c, c, 3, generator=g)
        self.norm1 = LearnableInstanceNorm(c) if use_in else None
        self.conv2 = flax_conv2d(c, c, 3, generator=g)
        self.conv1_3 = flax_conv2d(c, c, 1, generator=g)
        self.conv3_4 = flax_conv2d(2 * c, features, 1, generator=g)
        self.conv3 = flax_conv2d(2 * c, features, 3, generator=g)
        self.conv4 = flax_conv2d(features, features, 3, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        if self.norm1 is not None:
            x1 = self.norm1(x1)
        x1 = simam(F.leaky_relu(x1, self.relu_slope))
        x3 = torch.cat([self.conv2(x1), self.conv1_3(x)], 1)
        x3_4 = self.conv3_4(x3)
        x3 = F.leaky_relu(self.conv3(x3), self.relu_slope)
        return F.leaky_relu(self.conv4(x3), self.relu_slope) + x3_4


class DensityK(nn.Module):
    """The HVI transform's learnable density ``k`` (the reference's
    ``trans``)."""

    def __init__(self, density_k: float = 0.2):
        super().__init__()
        self.density_k = nn.Parameter(torch.full((1,), density_k))


def _up(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="bilinear",
                         align_corners=True)


# node (i, j) -> its inputs: (level, column, upsampled) in concat order
_INPUTS = {
    (3, 1): [(3, 0, False), (4, 0, True)],
    (2, 1): [(2, 0, False), (3, 0, True), (3, 1, True)],
    (1, 1): [(1, 0, False), (2, 0, True), (2, 1, True)],
    (0, 1): [(0, 0, False), (1, 0, True), (1, 1, True)],
    (2, 2): [(2, 0, False), (2, 1, False), (3, 1, True)],
    (1, 2): [(1, 0, False), (1, 1, False), (2, 1, True), (2, 2, True)],
    (0, 2): [(0, 0, False), (0, 1, False), (1, 1, True), (1, 2, True)],
    (1, 3): [(1, 0, False), (1, 1, False), (1, 2, False), (2, 2, True)],
    (0, 3): [(0, 0, False), (0, 1, False), (0, 2, False), (1, 2, True), (1, 3, True)],
    (0, 4): [(0, 0, False), (0, 1, False), (0, 2, False), (0, 3, False), (1, 3, True)],
}


class LLLiNetModule(nn.Module):
    """NHWC image -> {"enhanced"} (and {"hvi"}: the input in HVI space)."""

    def __init__(self, use_hvi: bool = False, density_k: float = 0.2,
                 filters: tuple = _FILTERS, generator: torch.Generator | None = None):
        super().__init__()
        f, g = tuple(filters), generator
        self.use_hvi = use_hvi
        self.trans = DensityK(density_k) if use_hvi else None
        for i in range(5):
            cin = 3 if i == 0 else f[i - 1]
            setattr(self, f"conv{i}_0", UNetConvBlock(cin, f[i], use_in=i > 0, generator=g))
        for (i, j), ins in _INPUTS.items():
            cin = sum(f[lvl] for lvl, _, _ in ins)
            setattr(self, f"conv{i}_{j}", UNetConvBlock(cin, f[i], generator=g))
        self.final = flax_conv2d(f[0], 3, 1, generator=g)

    def forward(self, x: torch.Tensor) -> dict:
        inp = x
        kv = self.trans.density_k[0] if self.use_hvi else None
        if self.use_hvi:
            x = rgb_to_hvi(x, density_k=kv)
        nodes = {}
        cur = x.permute(0, 3, 1, 2)
        for i in range(5):
            nodes[(i, 0)] = getattr(self, f"conv{i}_0")(cur)
            cur = F.max_pool2d(nodes[(i, 0)], 2)
        for (i, j), ins in _INPUTS.items():
            cat = torch.cat([_up(nodes[(lvl, col)]) if up else nodes[(lvl, col)]
                             for lvl, col, up in ins], 1)
            nodes[(i, j)] = getattr(self, f"conv{i}_{j}")(cat)
        y = self.final(nodes[(0, 4)]).permute(0, 2, 3, 1)
        if self.use_hvi:
            y = hvi_to_rgb(y, density_k=kv)
        out = {"enhanced": y.clamp(0.0, 1.0)}
        if self.use_hvi:
            out["hvi"] = rgb_to_hvi(inp, density_k=kv)
        return out


def _lllinet_loss():
    l1, ssim_l = LOSSES.build("l1_loss"), LOSSES.build("ssim_loss")

    def fn(outputs, datapoint):
        p, t = outputs["enhanced"], datapoint["ref_image"]
        return l1(p, t) + 0.5 * ssim_l(p, t)
    return fn


def _lllinet(name: str, use_hvi: bool, filters, generator) -> Model:
    return Model(name=name, arch="lllinet",
                 module=LLLiNetModule(use_hvi=use_hvi, filters=tuple(filters),
                                      generator=generator),
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,), loss_fn=_lllinet_loss(),
                 required_inputs=("image",), size_divisor=16)


@MODELS.register(name="lllinet", arch="lllinet", tasks=(Task.LLIE,),
                 schemes=(Scheme.SUPERVISED,))
def lllinet(filters=_FILTERS, generator: torch.Generator | None = None, **kwargs) -> Model:
    return _lllinet("lllinet", False, filters, generator)


@MODELS.register(name="lllinet_hvi", arch="lllinet", tasks=(Task.LLIE,),
                 schemes=(Scheme.SUPERVISED,))
def lllinet_hvi(filters=_FILTERS, generator: torch.Generator | None = None,
                **kwargs) -> Model:
    return _lllinet("lllinet_hvi", True, filters, generator)
