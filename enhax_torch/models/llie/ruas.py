"""RUAS: Retinex-inspired unrolling with architecture search (CVPR 2021).

Port of ``enhax/models/llie/ruas.py``. The searched genotypes are fixed, so
the search reduces to two cell layouts:

  * ``SearchBlock``: an information-distillation cell, three distill /
    remain op pairs and a tail op (``leaky_relu(0.05)`` after each), the
    four outputs concatenated and fused by a 1x1.
  * ``IEM``: t_hat = the 2x2 forward max of y (the first) or of u, less
    0.5 (u - y); t = clamp(sigmoid(cell(t_hat)), 1e-3, 1); u = clamp(y / t,
    0, 1). Three unrolled, each with its own weights.
  * the denoise branch: stem conv, three NRM cells, a conv; out = u - noise.

``ruas_loss``: 0.5 MSE(t_last, input) + ``sci_smooth_loss`` (sigma 0.1)
plus 1e-7 MSE(out, u) and the sum-over-count TV of out. A genotype op is a
conv (dilated where named, torch's explicit padding, residual where named)
or the identity. Parameter names are the reference's
(``enhance_net.iems.{i}.cell.c1_r.op``, ``denoise_net.stem``,
``denoise_net.nrms.{i}``, ``denoise_net.activate.0``). Images are NHWC; the
cells run NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.models.llie.sci import sci_smooth_loss
from enhax_torch.nn.layers import flax_conv2d

IEM_GENOTYPE = ("skip_connect", "resconv_1x1", "resdilconv_3x3", "conv_3x3",
                "conv_3x3", "skip_connect", "conv_3x3")
NRM_GENOTYPE = ("resconv_1x1", "resconv_1x1", "resdilconv_3x3", "skip_connect",
                "resconv_1x1", "resconv_1x1", "skip_connect")

# op name -> (kernel, dilation, residual); None: the identity
_OP_SPECS = {
    "skip_connect": None,
    "conv_1x1": (1, 1, False), "conv_3x3": (3, 1, False), "conv_5x5": (5, 1, False),
    "conv_7x7": (7, 1, False),
    "dilconv_3x3": (3, 2, False), "dilconv_5x5": (5, 2, False), "dilconv_7x7": (7, 2, False),
    "resconv_1x1": (1, 1, True), "resconv_3x3": (3, 1, True), "resconv_5x5": (5, 1, True),
    "resconv_7x7": (7, 1, True),
    "resdilconv_3x3": (3, 2, True), "resdilconv_5x5": (5, 2, True),
    "resdilconv_7x7": (7, 2, True),
}


class GenOp(nn.Module):
    """One genotype op: a conv (``op``) padded by ((k - 1) // 2) x
    dilation, plus its input where residual; or the identity."""

    def __init__(self, op_name: str, channels: int, generator=None):
        super().__init__()
        spec = _OP_SPECS[op_name]
        self.residual = bool(spec and spec[2])
        self.op = None
        if spec is not None:
            k, dil, _ = spec
            self.op = flax_conv2d(channels, channels, k, padding=((k - 1) // 2) * dil,
                                  generator=generator)
            self.op.dilation = (dil, dil)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op is None:
            return x
        y = self.op(x)
        return y + x if self.residual else y


class SearchBlock(nn.Module):
    def __init__(self, channels: int, genotype, generator=None):
        super().__init__()
        g = generator
        for name, op in zip(("c1_d", "c1_r", "c2_d", "c2_r", "c3_d", "c3_r", "c4"), genotype):
            setattr(self, name, GenOp(op, channels, g))
        self.c5 = flax_conv2d(4 * channels, channels, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def act(t):
            return F.leaky_relu(t, 0.05)
        d1 = act(self.c1_d(x))
        r1 = act(self.c1_r(x) + x)
        d2 = act(self.c2_d(r1))
        r2 = act(self.c2_r(r1) + r1)
        d3 = act(self.c3_d(r2))
        r3 = act(self.c3_r(r2) + r2)
        r4 = act(self.c4(r3))
        return self.c5(torch.cat([d1, d2, d3, r4], 1))


def forward_max2x2(x: torch.Tensor) -> torch.Tensor:
    """The max over (i..i+1, j..j+1) of NCHW ``x``, zero-padded at the bottom
    and the right."""
    xp = F.pad(x, (0, 1, 0, 1))
    a = torch.maximum(xp[:, :, :-1, :], xp[:, :, 1:, :])
    return torch.maximum(a[:, :, :, :-1], a[:, :, :, 1:])


class IEM(nn.Module):
    def __init__(self, channels: int = 3, generator=None):
        super().__init__()
        self.cell = SearchBlock(channels, IEM_GENOTYPE, generator)

    def forward(self, y: torch.Tensor, u: torch.Tensor, first: bool) -> tuple:
        t_hat = forward_max2x2(y) if first else forward_max2x2(u) - 0.5 * (u - y)
        t = torch.clamp(torch.sigmoid(self.cell(t_hat)), 1e-3, 1.0)
        return torch.clamp(y / t, 0.0, 1.0), t


class EnhanceNetwork(nn.Module):
    def __init__(self, iem_nums: int = 3, channels: int = 3, generator=None):
        super().__init__()
        self.iems = nn.ModuleList([IEM(channels, generator) for _ in range(iem_nums)])


class DenoiseNetwork(nn.Module):
    def __init__(self, nrm_nums: int = 3, channels: int = 6, generator=None):
        super().__init__()
        g = generator
        self.stem = flax_conv2d(3, channels, 3, generator=g)
        self.nrms = nn.ModuleList([SearchBlock(channels, NRM_GENOTYPE, g)
                                   for _ in range(nrm_nums)])
        self.activate = nn.Sequential(flax_conv2d(channels, 3, 3, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.stem(x)
        for nrm in self.nrms:
            feat = nrm(feat)
        return self.activate(feat)


class RUASModule(nn.Module):
    def __init__(self, iem_nums: int = 3, nrm_nums: int = 3, enhance_channels: int = 3,
                 denoise_channels: int = 6, with_denoise: bool = True, generator=None):
        super().__init__()
        self.enhance_net = EnhanceNetwork(iem_nums, enhance_channels, generator)
        self.denoise_net = (DenoiseNetwork(nrm_nums, denoise_channels, generator)
                            if with_denoise else None)

    def forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2)
        u = torch.ones_like(x)
        ts = []
        for i, iem in enumerate(self.enhance_net.iems):
            u, t = iem(x, u, i == 0)
            ts.append(t)
        out = u if self.denoise_net is None else u - self.denoise_net(u)
        return {"enhanced": out.permute(0, 2, 3, 1), "u_pre_denoise": u.permute(0, 2, 3, 1),
                "illu": torch.stack(ts).permute(0, 1, 3, 4, 2)}


def ruas_loss(outputs: dict, datapoint: dict) -> torch.Tensor:
    """The enhance terms on the last illumination, then the denoise terms."""
    x = datapoint["image"]
    t_last = outputs["illu"][-1]
    enhance = 0.5 * ((t_last - x) ** 2).mean() + sci_smooth_loss(x, t_last, sigma=0.1)
    u_d, u_e = outputs["enhanced"], outputs["u_pre_denoise"]
    n, h, w, c = u_d.shape
    tv_h = ((u_d[:, 1:] - u_d[:, :-1]) ** 2).sum()
    tv_w = ((u_d[:, :, 1:] - u_d[:, :, :-1]) ** 2).sum()
    tv = 2.0 * (tv_h / ((h - 1) * w * c) + tv_w / (h * (w - 1) * c)) / n
    return enhance + 1e-7 * ((u_d - u_e) ** 2).mean() + tv


@MODELS.register(name="ruas", arch="ruas", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def ruas(with_denoise: bool = True, generator: torch.Generator | None = None,
         **kwargs) -> Model:
    return Model(
        name="ruas", arch="ruas",
        module=RUASModule(with_denoise=with_denoise, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        loss_fn=ruas_loss,
        required_inputs=("image",),
        size_divisor=1,
    )
