"""RRDNet: Retinex decomposition, fitted to each image (zero-shot LLIE).

Port of ``enhax/models/llie/rrdnet.py``: three 5-conv branches predict the
illumination (1 channel, sigmoid), the reflectance (3, sigmoid) and the
noise (3, tanh); enhanced = illumination^gamma * (I - noise) / illumination.
``rrdnet_loss`` is the reference loss term for term: reconstruction,
gradient-weighted illumination smoothness, reflectance smoothness and the
illumination-weighted noise norm. As upstream (and the JAX package), the
smoothness weights are not detached from the graph. 1000 Adam steps at lr
1e-3 an image through ``Predictor``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d


class Branch(nn.Module):
    """conv0..conv3 (16, 32, 64, 32 channels, ReLU) and ``out``, 3x3, on
    NCHW maps."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (in_channels, 16, 32, 64, 32)
        for i in range(4):
            self.add_module(f"conv{i}", flax_conv2d(widths[i], widths[i + 1], 3,
                                                    generator=generator))
        self.out = flax_conv2d(32, out_channels, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return self.out(x)


class RRDNetModule(nn.Module):
    """NHWC image -> illumination, reflectance, noise and ``enhanced``."""

    def __init__(self, gamma: float = 0.4, generator: torch.Generator | None = None):
        super().__init__()
        self.gamma = gamma
        self.illumination_net = Branch(3, 1, generator)
        self.reflectance_net = Branch(3, 3, generator)
        self.noise_net = Branch(3, 3, generator)

    def forward(self, x: torch.Tensor) -> dict:
        xc = x.permute(0, 3, 1, 2)
        illumination = torch.sigmoid(self.illumination_net(xc)).permute(0, 2, 3, 1)
        reflectance = torch.sigmoid(self.reflectance_net(xc)).permute(0, 2, 3, 1)
        noise = torch.tanh(self.noise_net(xc)).permute(0, 2, 3, 1)
        enhanced = torch.pow(illumination, self.gamma) * ((x - noise) / illumination)
        return {"illumination": illumination, "reflectance": reflectance, "noise": noise,
                "enhanced": enhanced.clamp(0, 1)}


def _edge_pad(x: torch.Tensor, dim: int, p: int) -> torch.Tensor:
    """Pad ``dim`` by p copies of its first and last slices."""
    n = x.shape[dim]
    lo = x.narrow(dim, 0, 1).expand(*[p if d == dim % x.ndim else -1 for d in range(x.ndim)])
    hi = x.narrow(dim, n - 1, 1).expand(*[p if d == dim % x.ndim else -1
                                         for d in range(x.ndim)])
    return torch.cat([lo, x, hi], dim=dim)


def ref_gradient(x: torch.Tensor) -> tuple:
    """The reference ``Loss.gradient`` of NHWC x, per axis: |the central
    difference at offset 2| (edge-padded by 1) times |the one at offset 4|
    (edge-padded by 2)."""
    h, w = x.shape[-3], x.shape[-2]
    g1h = _edge_pad((x[..., 2:, :, :] - x[..., :h - 2, :, :]).abs(), -3, 1)
    g1w = _edge_pad((x[..., :, 2:, :] - x[..., :, :w - 2, :]).abs(), -2, 1)
    g2h = _edge_pad((x[..., 4:, :, :] - x[..., :h - 4, :, :]).abs(), -3, 2)
    g2w = _edge_pad((x[..., :, 4:, :] - x[..., :, :w - 4, :]).abs(), -2, 2)
    return g1h * g2h, g1w * g2w


def gauss5_zero(x: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """5x5 separable Gaussian (cv2.getGaussianKernel(5, 3)) of NHWC x with
    zero padding, along H then W."""
    i = np.arange(5) - 2.0
    k = np.exp(-(i ** 2) / (2.0 * sigma ** 2))
    k = (k / k.sum()).astype(np.float32).tolist()
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 2, 2, 2, 2))
    y = sum(k[j] * xp[:, j:j + h, 2:2 + w] for j in range(5))
    yp = F.pad(y, (0, 0, 2, 2))
    return sum(k[j] * yp[:, :, j:j + w] for j in range(5))


def rrdnet_loss(illu_factor: float = 1.0, reflect_factor: float = 1.0,
                noise_factor: float = 5000.0):
    """The reference loss, term for term (sums, not means)."""

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        image = datapoint["image"]
        illu, refl, noise = outputs["illumination"], outputs["reflectance"], outputs["noise"]
        recon = (image - (illu * refl + noise)).abs().sum()
        gray = 0.299 * image[..., :1] + 0.587 * image[..., 1:2] + 0.114 * image[..., 2:3]
        max_rgb = image.max(dim=-1, keepdim=True).values

        g_gray_h, g_gray_w = ref_gradient(gray)
        g_illu_h, g_illu_w = ref_gradient(illu)
        w_h = 1.0 / (gauss5_zero(g_gray_h) + 1e-4)
        w_w = 1.0 / (gauss5_zero(g_gray_w) + 1e-4)
        loss_illu = ((w_h * g_illu_h).sum() + (w_w * g_illu_w).sum()
                     + (illu - max_rgb).abs().sum())

        g_refl_h, g_refl_w = ref_gradient(refl)
        weight = 1.0 / (illu * g_gray_h * g_gray_w + 1e-4)
        weight = (weight - weight.min()) / (weight.max() - weight.min())
        loss_reflect = ((weight * g_refl_h).sum() + (weight * g_refl_w).sum()
                        + (image / illu - refl).abs().sum())

        loss_noise = torch.sqrt(((illu * noise) ** 2).sum())
        return (recon + illu_factor * loss_illu + reflect_factor * loss_reflect
                + noise_factor * loss_noise)
    return fn


@MODELS.register(name="rrdnet_re", arch="rrdnet", aliases=["rrdnet"], tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_REFERENCE, Scheme.INSTANCE))
def rrdnet_re(gamma: float = 0.4, generator: torch.Generator | None = None,
              **kwargs) -> Model:
    return Model(
        name="rrdnet_re", arch="rrdnet",
        module=RRDNetModule(gamma=gamma, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.ZERO_REFERENCE, Scheme.INSTANCE),
        loss_fn=rrdnet_loss(),
        required_inputs=("image",),
        instance_steps=1000, instance_lr=1e-3,
    )
