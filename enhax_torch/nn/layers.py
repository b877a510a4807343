"""Layers of the port.

Port of parts of ``enhax/nn/layers.py``:

  * ``DSConv`` and the plain 3x3 ``nn.Conv`` of ``zero_dce_re``. They take
    NCHW tensors.
  * The NAFNet layers: ``LayerNorm2d``, the 1x1 conv ``PWConv``/``conv1x1``,
    ``DWConv3x3``, ``NHWCConv2d`` and ``pixel_shuffle``/``pixel_unshuffle``.
    They take NHWC tensors, as the JAX layers do; a conv runs on the NCHW
    view of the NHWC tensor (channels_last in memory).

Flax's SAME padding at a 3x3 kernel and stride 1 is ``padding=1``. Parameter
names and shapes follow the reference torch code (``dw_conv``/``pw_conv``,
``weight``/``bias`` of ``nn.Conv2d``), so released checkpoints load as they
are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(in_channels: int, out_channels: int, bias: bool = True) -> nn.Conv2d:
    """3x3 conv, stride 1, SAME padding."""
    return nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=bias)


class DSConv(nn.Module):
    """Depthwise-separable conv: depthwise kxk, then pointwise 1x1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.dw_conv = nn.Conv2d(in_channels, in_channels, kernel_size,
                                 padding=kernel_size // 2, groups=in_channels,
                                 bias=bias)
        self.pw_conv = nn.Conv2d(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw_conv(self.dw_conv(x))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's default conv init: truncated normal (+-2 sigma) with variance
    1/fan_in, where fan_in counts one output channel's weights."""
    fan_in = weight[0].numel()
    # the std of a unit normal truncated at +-2
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


# -- NHWC layers of NAFNet ---------------------------------------------------

class NHWCConv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors (the JAX ``nn.Conv`` layout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PWConv(nn.Conv2d):
    """1x1 conv on NHWC tensors, as a channel matmul.

    Port of ``enhax/nn/layers.py::PWConv``. The JAX param is a Dense
    ``kernel`` (C_in, C_out); here it is a 1x1 ``Conv2d`` weight
    (C_out, C_in, 1, 1) under the reference name.
    """

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.reshape(self.out_channels, -1), self.bias)


def conv1x1(in_channels: int, out_channels: int, bias: bool = True) -> PWConv:
    """1x1 conv lowered to a channel matmul (see :class:`PWConv`)."""
    return PWConv(in_channels, out_channels, bias=bias)


class DWConv3x3(NHWCConv2d):
    """Depthwise 3x3 SAME conv on NHWC tensors.

    Port of ``enhax/nn/layers.py::DWConv3x3``. The JAX layer picks between
    shifted adds and the grouped conv by channel count, a TPU lowering
    choice; here it is one depthwise conv. Weight (C, 1, 3, 3).
    """

    def __init__(self, channels: int, bias: bool = True):
        super().__init__(channels, channels, 3, padding=1, groups=channels, bias=bias)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NHWC map: biased variance, eps 1e-6.

    Port of ``enhax/nn/layers.py::LayerNorm2d``; its ``scale`` is ``weight``
    here, as in the reference torch code.
    """

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last axis."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,H,W,C*r^2) -> (N,H*r,W*r,C), channels in torch's (C, r, r) order."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/r,W/r,C*r^2), channels in torch's (C, r, r) order."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


class PixelShuffle(nn.Module):
    """``pixel_shuffle`` as a module (no params), for ``nn.Sequential``."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.factor)
