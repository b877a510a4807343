"""PairLIE: learning from paired low-light instances (CVPR 2023).

Port of ``enhax/models/llie/pairlie.py``: three nets of five reflect-padded
3x3 convs (ReLU between, sigmoid last):

  X = N_net(input)   the noise-removed image
  L = L_net(X)       1-channel illumination
  R = R_net(X)       3-channel reflectance
  enhanced = L^exponent R   (0.2 by default)

``pairlie_forward_loss`` (the model's ``forward_loss_fn``): MSE(L R, X) +
MSE(R, X / clamp(L.detach(), 1e-4, 1)) + MSE(L, max_rgb(input)) + TV(L) +
500 MSE(input, X), plus MSE(R1, R2) where the datapoint carries a second
view of the scene (``image2``). Parameter names are the reference's
(``L_net.L_net.{1,4,7,10,13}``, the convs of each net's Sequential).
Images are NHWC; the nets run NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d


def _five_convs(in_channels: int, out_channels: int, num: int, generator=None) -> nn.Sequential:
    layers = []
    for i, (cin, cout) in enumerate(((in_channels, num), (num, num), (num, num), (num, num),
                                     (num, out_channels))):
        layers += [nn.ReflectionPad2d(1), flax_conv2d(cin, cout, 3, padding=0,
                                                      generator=generator)]
        layers.append(nn.ReLU() if i < 4 else nn.Sigmoid())
    return nn.Sequential(*layers)


class FiveConvNet(nn.Module):
    """One of the reference's ``N_net``/``L_net``/``R_net``: its Sequential
    under the net's own name."""

    def __init__(self, name: str, out_channels: int, num: int = 64, generator=None):
        super().__init__()
        self.name = name
        setattr(self, name, _five_convs(3, out_channels, num, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.name)(x)


class PairLIEModule(nn.Module):
    def __init__(self, num: int = 64, exponent: float = 0.2, generator=None):
        super().__init__()
        self.exponent = exponent
        self.N_net = FiveConvNet("N_net", 3, num, generator)
        self.L_net = FiveConvNet("L_net", 1, num, generator)
        self.R_net = FiveConvNet("R_net", 3, num, generator)

    def forward(self, x: torch.Tensor) -> dict:
        clean = self.N_net(x.permute(0, 3, 1, 2))
        illu = self.L_net(clean)
        refl = self.R_net(clean)
        enhanced = torch.pow(illu, self.exponent) * refl

        def nhwc(t):
            return t.permute(0, 2, 3, 1)
        return {"enhanced": nhwc(enhanced), "illumination": nhwc(illu),
                "reflectance": nhwc(refl), "clean": nhwc(clean)}


def _tv_loss(l: torch.Tensor) -> torch.Tensor:
    return ((l[:, 2:] - l[:, :-2]).abs().mean()
            + (l[:, :, 2:] - l[:, :, :-2]).abs().mean())


def pairlie_forward_loss(model: Model, datapoint: dict) -> tuple:
    """The reference's pair losses; the cross-view term only with ``image2``."""
    x1 = datapoint["image"]
    out1 = model.apply({"image": x1}, training=True)
    L1, R1, X1 = out1["illumination"], out1["reflectance"], out1["clean"]

    def mse(a, b):
        return ((a - b) ** 2).mean()
    max_rgb = x1.amax(-1, keepdim=True)
    r_loss = (mse(L1 * R1, X1) + mse(R1, X1 / L1.detach().clamp(1e-4, 1.0))
              + mse(L1, max_rgb) + _tv_loss(L1))
    total = r_loss + 500.0 * mse(x1, X1)
    if datapoint.get("image2") is not None:
        out2 = model.apply({"image": datapoint["image2"]}, training=True)
        total = total + mse(R1, out2["reflectance"])
    return total, out1


@MODELS.register(name="pairlie", arch="pairlie", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED,))
def pairlie(num: int = 64, exponent: float = 0.2, generator: torch.Generator | None = None,
            **kwargs) -> Model:
    return Model(
        name="pairlie", arch="pairlie",
        module=PairLIEModule(num=num, exponent=exponent, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED,),
        forward_loss_fn=pairlie_forward_loss,
        required_inputs=("image",),
        size_divisor=1,
    )
