"""SCI: self-calibrated illumination learning (CVPR 2022).

Port of ``enhax/models/llie/sci.py``:

  * ``EnhanceNet``: in_conv + ReLU, one conv + BatchNorm + ReLU block
    applied ``layers`` times with the same weights (the reference appends
    one Sequential to ``blocks`` repeatedly), sigmoid out_conv;
    illu = clamp(fea + input, 1e-4, 1).
  * ``CalibrateNet``: in_conv + BatchNorm + ReLU, a double conv + BatchNorm
    + ReLU block shared across its ``layers``; delta = input - sigmoid(out).
  * the stage loop (3 stages, weights shared): illu = enhance(input_op),
    r = clamp(x / illu, 0, 1), input_op = x + calibrate(r); the output is
    the first stage's clamp(x / illu), the reference's inference model.
  * ``sci_loss``: per stage 1.5 MSE(illu, input) + ``sci_smooth_loss``
    (24 offsets, weights from the YCbCr differences).

The BatchNorms normalise with their running statistics in training too, as
the JAX package's ``use_running_average=True`` does (``RunningBatchNorm2d``:
``F.batch_norm(..., training=False)``; the Trainer's train mode neither
reads the batch's statistics nor updates the buffers). Parameter names are
the reference's (``enhance.in_conv.0``, ``enhance.conv.{0,1}``,
``calibrate.convs.{0,1,3,4}``; the shared blocks again under ``blocks.i``),
so a released checkpoint loads as it is. Images are NHWC; the nets run
NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d


class RunningBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that always normalises with its running
    statistics and never updates them (flax's ``use_running_average=True``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


def conv_bn_relu(channels: int, generator=None) -> list:
    return [flax_conv2d(channels, channels, 3, generator=generator),
            RunningBatchNorm2d(channels), nn.ReLU()]


class EnhanceNet(nn.Module):
    def __init__(self, layers: int = 1, channels: int = 3, generator=None):
        super().__init__()
        g = generator
        self.in_conv = nn.Sequential(flax_conv2d(3, channels, 3, generator=g), nn.ReLU())
        self.conv = nn.Sequential(*conv_bn_relu(channels, g))
        self.blocks = nn.ModuleList([self.conv] * layers)
        self.out_conv = nn.Sequential(flax_conv2d(channels, 3, 3, generator=g), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.in_conv(x)
        for block in self.blocks:
            fea = fea + block(fea)
        return torch.clamp(self.out_conv(fea) + x, 1e-4, 1.0)


class CalibrateNet(nn.Module):
    def __init__(self, layers: int = 3, channels: int = 16, generator=None):
        super().__init__()
        g = generator
        self.in_conv = nn.Sequential(flax_conv2d(3, channels, 3, generator=g),
                                     RunningBatchNorm2d(channels), nn.ReLU())
        self.convs = nn.Sequential(*conv_bn_relu(channels, g), *conv_bn_relu(channels, g))
        self.blocks = nn.ModuleList([self.convs] * layers)
        self.out_conv = nn.Sequential(flax_conv2d(channels, 3, 3, generator=g), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.in_conv(x)
        for block in self.blocks:
            fea = fea + block(fea)
        return x - self.out_conv(fea)


class SCIModule(nn.Module):
    def __init__(self, stage: int = 3, generator=None):
        super().__init__()
        self.stage = stage
        self.enhance = EnhanceNet(generator=generator)
        self.calibrate = CalibrateNet(generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2)
        inp = x
        illus, ins = [], []
        for _ in range(self.stage):
            ins.append(inp)
            illu = self.enhance(inp)
            r = torch.clamp(x / illu, 0.0, 1.0)
            inp = x + self.calibrate(r)
            illus.append(illu)
        nhwc = (0, 1, 3, 4, 2)
        return {"enhanced": torch.clamp(x / illus[0], 0.0, 1.0).permute(0, 2, 3, 1),
                "illu": torch.stack(illus).permute(nhwc),
                "stage_inputs": torch.stack(ins).permute(nhwc)}


_YCBCR_MAT = ((0.257, -0.148, 0.439), (0.564, -0.291, -0.368), (0.098, 0.439, -0.071))
_YCBCR_BIAS = (16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0)
# the 24 directions of the reference's loss
_OFFSETS = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3) if (dy, dx) != (0, 0)]


def _shift_pair(t: torch.Tensor, dy: int, dx: int) -> tuple:
    """The valid region of NHWC ``t`` and its copy shifted by (dy, dx)."""
    h, w = t.shape[1], t.shape[2]
    y0, y1 = max(dy, 0), h + min(dy, 0)
    x0, x1 = max(dx, 0), w + min(dx, 0)
    return t[:, y0:y1, x0:x1, :], t[:, y0 - dy:y1 - dy, x0 - dx:x1 - dx, :]


def sci_smooth_loss(image: torch.Tensor, illu: torch.Tensor, sigma: float = 10.0) -> torch.Tensor:
    """The 24-direction bilateral smoothness of ``illu`` (NHWC), weighted by
    exp(-|d YCbCr(image)|^2 / (2 sigma^2)): the sum over directions of the
    mean of weight x the L1 over channels of the difference."""
    mat = torch.tensor(_YCBCR_MAT, dtype=image.dtype, device=image.device)
    ycc = image @ mat + torch.tensor(_YCBCR_BIAS, dtype=image.dtype, device=image.device)
    sigma_color = -1.0 / (2 * sigma * sigma)
    total = 0.0
    for dy, dx in _OFFSETS:
        ga, gb = _shift_pair(ycc, dy, dx)
        w = torch.exp(((ga - gb) ** 2).sum(-1, keepdim=True) * sigma_color)
        oa, ob = _shift_pair(illu, dy, dx)
        total = total + (w * (oa - ob).abs().sum(-1, keepdim=True)).mean()
    return total


def sci_loss(outputs: dict, datapoint: dict) -> torch.Tensor:
    """The sum over stages of 1.5 MSE(illu, input) + the smoothness."""
    illus, ins = outputs["illu"], outputs["stage_inputs"]
    total = 0.0
    for s in range(illus.shape[0]):
        total = total + 1.5 * ((illus[s] - ins[s]) ** 2).mean() + sci_smooth_loss(ins[s], illus[s])
    return total


@MODELS.register(name="sci", arch="sci", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def sci(stage: int = 3, generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="sci", arch="sci",
        module=SCIModule(stage=stage, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        loss_fn=sci_loss,
        required_inputs=("image",),
        size_divisor=1,
    )
