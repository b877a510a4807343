"""Losses of the port (NHWC images in [0, 1]).

Port of ``reduce_loss`` and ``psnr_loss`` from ``enhax/nn/losses.py``. A
registered entry is a constructor: ``LOSSES.build(name, **params)`` returns
``loss(input, target) -> scalar``. The other losses of the JAX package come
with the models that train on them (ROADMAP items 1.7 and 1.15).
"""

from __future__ import annotations

import math

import torch

from enhax_torch.constants import LOSSES

_Y_COEF = (65.481, 128.553, 24.966)


def reduce_loss(loss: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _to_y(x: torch.Tensor) -> torch.Tensor:
    coef = torch.tensor(_Y_COEF, dtype=x.dtype, device=x.device)
    return ((x * coef).sum(dim=-1, keepdim=True) + 16.0) / 255.0


@LOSSES.register(name="psnr_loss")
def psnr_loss(to_y: bool = False, loss_weight: float = 1.0, reduction: str = "mean"):
    """The negative-PSNR-shaped loss of BasicSR: 10 / ln 10 times the mean
    over images of log(mse + 1e-8), mse taken over each image's H, W, C.
    (``reduction`` is accepted and, as in the JAX package, unused.)"""
    scale = 10.0 / math.log(10.0)

    def fn(input, target, **_):
        x, y = input, target
        if to_y:
            x, y = _to_y(x), _to_y(y)
        mse = ((x - y) ** 2).mean(dim=(-3, -2, -1))
        return loss_weight * scale * torch.log(mse + 1e-8).mean()
    return fn
