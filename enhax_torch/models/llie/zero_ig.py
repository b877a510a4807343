"""ZERO-IG: zero-shot illumination-guided joint denoising and enhancement.

Port of ``enhax/models/llie/zero_ig.py``: two denoisers (3 and 6 channels),
an illumination estimator (``Enhance``: one shared Conv + BatchNorm + ReLU
residual block applied three times, a sigmoid head clamped to [1e-4, 1]),
and the pair-downsample branches that feed the self-supervised loss;
``enhanced`` is h2 = clip(I / s2). The loss is the reference's term for
term: adaptive brightness targets, the flat-view "YCbCr" smoothness, the
ZSN2N-style residual and consistency terms, the 21x21 erf-kernel blur
(reflect padding), the texture-gated local means (reflect padding) and the
local variances (zero padding).

It trains through the train CLI (``configs/zero_ig_re_*.py``) and serves
through ``Predictor``'s instance route (1000 Adam steps at 1e-4). The
BatchNorm normalises with its statistics, which are parameters
(``ReferenceFrozenBatchNorm2d``): the instance fit steps them with the
weights, the Trainer does not, as in the JAX package. Parameter names are
the reference's (``enhance.in_conv.0``, ``enhance.conv.0``/``.1``, the
shared block again under ``enhance.blocks.{i}``, ``enhance.out_conv.0``),
so a released ``.pth`` loads as it is. The module holds NCHW maps; in and
out NHWC.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import ReferenceFrozenBatchNorm2d, flax_conv2d
from enhax_torch.ops.geometry import pair_downsample


class DenoiseNet(nn.Module):
    """3x3 -> LeakyReLU(0.2) -> 3x3 -> LeakyReLU(0.2) -> 1x1."""

    def __init__(self, embed_channels: int = 48, in_out: int = 3, generator=None):
        super().__init__()
        g = generator
        self.conv1 = flax_conv2d(in_out, embed_channels, 3, generator=g)
        self.conv2 = flax_conv2d(embed_channels, embed_channels, 3, generator=g)
        self.conv3 = flax_conv2d(embed_channels, in_out, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv1(x), 0.2)
        return self.conv3(F.leaky_relu(self.conv2(y), 0.2))


class Enhance(nn.Module):
    def __init__(self, channels: int = 64, layers: int = 3, generator=None):
        super().__init__()
        g = generator
        self.in_conv = nn.Sequential(flax_conv2d(3, channels, 3, generator=g), nn.ReLU())
        self.conv = nn.Sequential(flax_conv2d(channels, channels, 3, generator=g),
                                  ReferenceFrozenBatchNorm2d(channels), nn.ReLU())
        self.blocks = nn.ModuleList([self.conv] * layers)
        self.out_conv = nn.Sequential(flax_conv2d(channels, 3, 3, generator=g), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.in_conv(x)
        for block in self.blocks:
            fea = fea + block(fea)
        return self.out_conv(fea).clamp(1e-4, 1.0)


def _blur_kernel21() -> torch.Tensor:
    """21x21: the differences of the normal CDF over [-1.05, 1.05], the
    square root of their outer product, normalised (float64, then float32)."""
    ks, ns = 21, 1
    interval = (2 * ns + 1.0) / ks
    grid = np.linspace(-ns - interval / 2.0, ns + interval / 2.0, ks + 1)
    cdf = 0.5 * (1 + np.array([math.erf(v / math.sqrt(2.0)) for v in grid]))
    k1 = np.diff(cdf)
    k2 = np.sqrt(np.outer(k1, k1))
    return torch.from_numpy((k2 / k2.sum()).astype(np.float32))


_KERNEL21 = _blur_kernel21()


def _blur21(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 21x21 blur of an NCHW map, reflect padding."""
    n, c, h, w = x.shape
    xp = F.pad(x, (10, 10, 10, 10), mode="reflect").reshape(n * c, 1, h + 20, w + 20)
    k = _KERNEL21.to(x)[None, None]
    return F.conv2d(xp, k).reshape(n, c, h, w)


def _mean5_zero(x: torch.Tensor) -> torch.Tensor:
    """The 5x5 mean of the zero-padded map. The padding is explicit: torch
    2.11's CUDA ``avg_pool2d`` with ``padding`` returns wrong gradients for a
    channels-last input (0.38 off on (2, 3, 64, 64), float64), which these
    maps, permuted from NHWC, are."""
    return F.avg_pool2d(F.pad(x, (2, 2, 2, 2)), 5, stride=1)


def _local_var5(x: torch.Tensor) -> torch.Tensor:
    """The zero-padded 5x5 mean of (x - its zero-padded 5x5 mean)^2."""
    d = x - _mean5_zero(x)
    return _mean5_zero(d * d)


def _local_mean5_reflect(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), 5, stride=1)


def _local_stddev5_reflect(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    xp = F.pad(x, (2, 2, 2, 2), mode="reflect")
    s = F.avg_pool2d(xp, 5, stride=1)
    s2 = F.avg_pool2d(xp * xp, 5, stride=1)
    return torch.sqrt((s2 - s * s).clamp_min(0.0) + eps)


def texture_difference(a: torch.Tensor, b: torch.Tensor, constant_c: float = 1e-5,
                       threshold: float = 0.975) -> torch.Tensor:
    """1 where the local standard deviations of the (reversed-weight) grays
    of a and b are similar, else 0 (NCHW)."""
    def gray(t):
        return 0.144 * t[:, 0:1] + 0.587 * t[:, 1:2] + 0.299 * t[:, 2:3]
    s1, s2 = _local_stddev5_reflect(gray(a)), _local_stddev5_reflect(gray(b))
    diff = 2 * s1 * s2 / (s1 ** 2 + s2 ** 2 + constant_c)
    return (diff > threshold).to(a.dtype)


# (rows, cols) slices of the 24 directional differences, and their opposites
_OFFSETS = [((1, None), (None, None)), ((None, -1), (None, None)),
            ((None, None), (1, None)), ((None, None), (None, -1)),
            ((None, -1), (None, -1)), ((1, None), (1, None)),
            ((1, None), (None, -1)), ((None, -1), (1, None)),
            ((2, None), (None, None)), ((None, -2), (None, None)),
            ((None, None), (2, None)), ((None, None), (None, -2)),
            ((None, -2), (None, -1)), ((2, None), (1, None)),
            ((2, None), (None, -1)), ((None, -2), (1, None)),
            ((None, -1), (None, -2)), ((1, None), (2, None)),
            ((1, None), (None, -2)), ((None, -1), (2, None)),
            ((None, -2), (None, -2)), ((2, None), (2, None)),
            ((2, None), (None, -2)), ((None, -2), (2, None))]


def _opposite(s: tuple) -> tuple:
    a, b = s
    if a is None and b is None:
        return s
    if a is not None and b is None:
        return (None, -a)
    return (-b, None)


def _smooth_loss(inp: torch.Tensor, target: torch.Tensor, sigma: float = 10.0) -> torch.Tensor:
    """The 24 directional bilateral weights of the reference's "YCbCr" (the
    NCHW tensor viewed as rows of 3) on the L1 channel norm of the target's
    differences (NCHW)."""
    n, c, h, w = inp.shape
    mat = inp.new_tensor([[0.257, -0.148, 0.439], [0.564, -0.291, -0.368],
                          [0.098, 0.439, -0.071]])
    bias = inp.new_tensor([16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0])
    y = (inp.reshape(-1, 3) @ mat + bias).reshape(n, c, h, w)
    sc = -1.0 / (2 * sigma * sigma)

    def shift(v, hs, ws):
        return v[:, :, hs[0]:hs[1], ws[0]:ws[1]]

    total = 0.0
    for hs, ws in _OFFSETS:
        ohs, ows = _opposite(hs), _opposite(ws)
        wgt = torch.exp(((shift(y, hs, ws) - shift(y, ohs, ows)) ** 2).sum(1, keepdim=True) * sc)
        grad = (shift(target, hs, ws) - shift(target, ohs, ows)).abs().sum(1, keepdim=True)
        total = total + (wgt * grad).mean()
    return total


def _pair_down(x: torch.Tensor) -> tuple:
    """``pair_downsample`` of an NCHW map."""
    a, b = pair_downsample(x.permute(0, 2, 3, 1))
    return a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)


class ZeroIGModule(nn.Module):
    """NHWC image -> the training branch's maps (NHWC); ``enhanced`` is h2."""

    def __init__(self, num_channels: int = 64, embed_channels: int = 48, generator=None):
        super().__init__()
        self.denoise1 = DenoiseNet(embed_channels, 3, generator)
        self.denoise2 = DenoiseNet(embed_channels, 6, generator)
        self.enhance = Enhance(num_channels, generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        eps = 1e-4
        image = x.permute(0, 3, 1, 2) + eps
        d1, d2, enh = self.denoise1, self.denoise2, self.enhance
        l11, l12 = _pair_down(image)
        l_pred1 = l11 - d1(l11)
        l_pred2 = l12 - d1(l12)
        l2 = (image - d1(image)).clamp(eps, 1.0)
        s2 = enh(l2.detach())
        s21, s22 = _pair_down(s2)
        h2 = (image / s2).clamp(eps, 1.0)
        h11 = (l11 / s21).clamp(eps, 1.0)
        h12 = (l12 / s22).clamp(eps, 1.0)
        cat1 = torch.cat([h11, s21], 1)
        h3_pred = (cat1.detach() - d2(cat1)).clamp(eps, 1.0)
        cat2 = torch.cat([h12, s22], 1)
        h4_pred = (cat2.detach() - d2(cat2)).clamp(eps, 1.0)
        cat5 = torch.cat([h2, s2], 1)
        h5_pred = (cat5.detach() - d2(cat5)).clamp(eps, 1.0)
        h3, s3 = h5_pred[:, :3], h5_pred[:, 3:]
        h1 = (l2 / s2).clamp(0.0, 1.0)
        out = {"l_pred1": l_pred1, "l_pred2": l_pred2, "l2": l2, "s2": s2, "s21": s21,
               "s22": s22, "h2": h2, "h11": h11, "h12": h12,
               "h13": h3_pred[:, :3], "s13": h3_pred[:, 3:],
               "h14": h4_pred[:, :3], "s14": h4_pred[:, 3:], "h3": h3, "s3": s3,
               "h3_pred": h3_pred, "h4_pred": h4_pred,
               "h2_blur": _blur21(h1), "h3_blur": _blur21(h3), "denoise": h3, "enhanced": h2}
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def zero_ig_forward_loss(model: Model, datapoint: dict) -> tuple:
    """The reference's loss, term for term (NCHW inside)."""
    out = model.apply(datapoint, training=True)
    o = {k: _nchw(v) for k, v in out.items()}
    eps = 1e-9
    image = _nchw(datapoint["image"]) + eps
    l2, s2, h2, h3 = o["l2"], o["s2"], o["h2"], o["h3"]
    l2d = l2.detach()

    # adaptive brightness targets (the reference's reversed Y weights)
    input_y = l2d[:, 2] * 0.299 + l2d[:, 1] * 0.587 + l2d[:, 0] * 0.144
    y_mean = input_y.mean(dim=(-2, -1))[:, None, None, None]
    factor = (0.5 / (y_mean + eps)).clamp(1.0, 25.0)
    adjustment_ratio = torch.pow(0.7, -factor) / factor
    norm_low = (l2d / s2).clamp(eps, 0.8)
    enhanced_brightness = torch.pow(l2d * factor, factor)
    clamped_eb = (enhanced_brightness * adjustment_ratio).clamp(eps, 1.0)
    clamped_adj = (l2d * factor).clamp(eps, 1.0)
    loss = 700.0 * _mse(s2, clamped_eb) + 1000.0 * _mse(norm_low, clamped_adj)
    loss = loss + 5.0 * _smooth_loss(l2d, s2)
    tv_b, tv_c, tv_h, tv_w = s2.shape
    h_tv = ((s2[:, :, 1:] - s2[:, :, :-1]) ** 2).sum()
    w_tv = ((s2[:, :, :, 1:] - s2[:, :, :, :-1]) ** 2).sum()
    loss = loss + 1600.0 * 2 * (h_tv / ((tv_h - 1) * tv_w * tv_c)
                                + w_tv / (tv_h * (tv_w - 1) * tv_c)) / tv_b

    # the first stage's residual and consistency
    l11, l12 = _pair_down(image)
    loss = loss + 1000.0 * (_mse(l11, o["l_pred2"]) + _mse(l12, o["l_pred1"]))
    den1, den2 = _pair_down(l2)
    loss = loss + 1000.0 * (_mse(o["l_pred1"], den1) + _mse(o["l_pred2"], den2))

    # the second stage's
    loss = loss + 1000.0 * _mse(o["h3_pred"], torch.cat([o["h12"], o["s22"]], 1).detach())
    loss = loss + 1000.0 * _mse(o["h4_pred"], torch.cat([o["h11"], o["s21"]], 1).detach())
    h3d1, h3d2 = _pair_down(h3)
    loss = loss + 1000.0 * (_mse(o["h3_pred"][:, :3], h3d1) + _mse(o["h4_pred"][:, :3], h3d2))

    # colour and illumination
    loss = loss + 10000.0 * _mse(o["h2_blur"].detach(), o["h3_blur"])
    loss = loss + 1000.0 * _mse(s2.detach(), o["s3"])

    # the texture-gated consistency (the gate reuses h3d1 in both)
    gate = texture_difference(h3d1, h3d2)
    wd1 = (1.0 - gate) * _local_mean5_reflect(h3d1) + h3d1 * gate
    wd2 = (1.0 - gate) * _local_mean5_reflect(h3d2) + h3d1 * gate
    loss = loss + 10000.0 * (_mse(h3d1, wd1) + _mse(h3d2, wd2))

    # the local variances
    loss = loss + 1000.0 * _mse(_local_var5(h2), _local_var5(h3 - h2))
    return loss, out


@MODELS.register(name="zero_ig_re", arch="zero_ig", aliases=["zero_ig"], tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def zero_ig_re(num_channels: int = 64, embed_channels: int = 48,
               generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(name="zero_ig_re", arch="zero_ig",
                 module=ZeroIGModule(num_channels, embed_channels, generator),
                 tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
                 forward_loss_fn=zero_ig_forward_loss, required_inputs=("image",),
                 instance_steps=1000, instance_lr=1e-4, size_divisor=2)
