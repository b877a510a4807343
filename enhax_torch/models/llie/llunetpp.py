"""LLUNet++: UNet++ (nested dense skips) for supervised low-light enhancement.

Port of ``enhax/models/llie/llunetpp.py``. Node (i, j) takes X(i, 0..j-1)
and the bilinear (align_corners) upsample of X(i+1, j-1); each node is a
gated residual ``UNetConvBlock`` (conv + affine instance norm + LeakyReLU,
a 1x1 shortcut concatenated, two more convs, plus a 1x1 of the concat); a
final 1x1 and a clamp to [0, 1]. The module holds NCHW maps; in and out
NHWC. Parameter names are the reference's (``conv{i}_{j}``), so a released
``.pth`` loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import InstanceNorm2d, flax_conv2d

_FILTERS = (32, 64, 128, 256, 512)


class UNetConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, relu_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, g = in_channels, generator
        self.relu_slope = relu_slope
        self.conv1_2 = flax_conv2d(c, c, 1, generator=g)
        self.conv1 = flax_conv2d(c, c, 3, generator=g)
        self.norm1 = InstanceNorm2d(c)
        self.conv2_3 = flax_conv2d(2 * c, features, 1, generator=g)
        self.conv2 = flax_conv2d(2 * c, features, 3, generator=g)
        self.conv3 = flax_conv2d(features, features, 3, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1_2 = self.conv1_2(x)
        x1 = F.leaky_relu(self.norm1(self.conv1(x)), self.relu_slope)
        x2 = torch.cat([x1, x1_2], 1)
        x2_3 = self.conv2_3(x2)
        x2 = F.leaky_relu(self.conv2(x2), self.relu_slope)
        return F.leaky_relu(self.conv3(x2), self.relu_slope) + x2_3


class LLUnetPPModule(nn.Module):
    """NHWC image -> {"enhanced"}."""

    def __init__(self, filters: tuple = _FILTERS, generator: torch.Generator | None = None):
        super().__init__()
        f, g = tuple(filters), generator
        self.levels = n = len(f)
        for i in range(n):
            setattr(self, f"conv{i}_0",
                    UNetConvBlock(3 if i == 0 else f[i - 1], f[i], generator=g))
        for j in range(1, n):
            for i in range(n - j):
                setattr(self, f"conv{i}_{j}",
                        UNetConvBlock(j * f[i] + f[i + 1], f[i], generator=g))
        self.final = flax_conv2d(f[0], 3, 1, generator=g)

    def forward(self, x: torch.Tensor) -> dict:
        n = self.levels
        nodes = {}
        cur = x.permute(0, 3, 1, 2)
        for i in range(n):
            nodes[(i, 0)] = getattr(self, f"conv{i}_0")(cur)
            if i < n - 1:
                cur = F.max_pool2d(nodes[(i, 0)], 2)
        for j in range(1, n):
            for i in range(n - j):
                skips = [nodes[(i, k)] for k in range(j)]
                upped = F.interpolate(nodes[(i + 1, j - 1)], size=skips[0].shape[-2:],
                                      mode="bilinear", align_corners=True)
                nodes[(i, j)] = getattr(self, f"conv{i}_{j}")(torch.cat(skips + [upped], 1))
        out = self.final(nodes[(0, n - 1)]).permute(0, 2, 3, 1)
        return {"enhanced": out.clamp(0.0, 1.0)}


def _llunetpp_loss():
    l1, ssim_l = LOSSES.build("l1_loss"), LOSSES.build("ssim_loss")
    per = LOSSES.build("perceptual_loss")

    def fn(outputs, datapoint):
        p, t = outputs["enhanced"], datapoint["ref_image"]
        return l1(p, t) + 0.5 * ssim_l(p, t) + 0.1 * per(p, t)
    return fn


@MODELS.register(name="llunet++_re", arch="llunetpp",
                 aliases=["llunetpp_re", "llunetpp", "llunet++"], tasks=(Task.LLIE,),
                 schemes=(Scheme.SUPERVISED,))
def llunetpp_re(filters=_FILTERS, generator: torch.Generator | None = None,
                **kwargs) -> Model:
    return Model(name="llunet++_re", arch="llunetpp",
                 module=LLUnetPPModule(filters=tuple(filters), generator=generator),
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,), loss_fn=_llunetpp_loss(),
                 required_inputs=("image",), size_divisor=16)
