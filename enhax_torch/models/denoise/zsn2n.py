"""ZSN2N: zero-shot Noise2Noise denoising, fitted to each image.

Port of ``enhax/models/denoise/zsn2n.py``: a 3-conv LeakyReLU(0.2) noise
predictor; ``enhanced`` is the image less the predicted noise. Its loss
(``forward_loss_fn``) runs three forwards a step: the two pair-downsampled
halves and the image (residual + consistency). 3000 Adam steps at lr 1e-3 an
image through ``Predictor``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d
from enhax_torch.ops.geometry import pair_downsample


class ZSN2NNet(nn.Module):
    """NHWC image -> {"noise", "enhanced": clip(image - noise)}."""

    def __init__(self, in_channels: int = 3, num_channels: int = 48,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = flax_conv2d(in_channels, num_channels, 3, generator=generator)
        self.conv2 = flax_conv2d(num_channels, num_channels, 3, generator=generator)
        self.conv3 = flax_conv2d(num_channels, in_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        y = F.leaky_relu(self.conv1(x.permute(0, 3, 1, 2)), 0.2)
        y = F.leaky_relu(self.conv2(y), 0.2)
        noise = self.conv3(y).permute(0, 2, 3, 1)
        return {"noise": noise, "enhanced": (x - noise).clamp(0.0, 1.0)}


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def zsn2n_forward_loss(model: Model, datapoint: dict) -> tuple:
    """Residual + consistency loss over the pair-downsampled halves."""
    noisy = datapoint["image"]
    n1, n2 = pair_downsample(noisy)

    def f(img):
        return model.apply({"image": img}, training=True)

    out1, out2, out = f(n1), f(n2), f(noisy)
    pred1, pred2 = n1 - out1["noise"], n2 - out2["noise"]
    den1, den2 = pair_downsample(noisy - out["noise"])
    loss_res = 0.5 * (_mse(n1, pred2) + _mse(n2, pred1))
    loss_cons = 0.5 * (_mse(pred1, den1) + _mse(pred2, den2))
    return loss_res + loss_cons, out


@MODELS.register(name="zsn2n", arch="zsn2n", tasks=(Task.DENOISE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE, Scheme.INSTANCE))
def zsn2n(num_channels: int = 48, generator: torch.Generator | None = None,
          **kwargs) -> Model:
    return Model(
        name="zsn2n", arch="zsn2n",
        module=ZSN2NNet(num_channels=num_channels, generator=generator),
        tasks=(Task.DENOISE,),
        schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE, Scheme.INSTANCE),
        forward_loss_fn=zsn2n_forward_loss,
        required_inputs=("image",),
        instance_steps=3000, instance_lr=1e-3,
    )
