"""Losses of the port (NHWC images in [0, 1]).

Port of ``reduce_loss``, ``psnr_loss`` and Zero-DCE's zero-reference
losses (spatial consistency, exposure control, colour constancy, total
variation) from ``enhax/nn/losses.py``. A registered entry is a
constructor: ``LOSSES.build(name, **params)`` returns ``loss(input,
target) -> scalar``. The other losses of the JAX package come with the
models that train on them (ROADMAP items 1.12 and 1.15).
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


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean over (..., H, W, C), cropped to multiples of k."""
    h, w = x.shape[-3] // k, x.shape[-2] // k
    x = x[..., : h * k, : w * k, :]
    return x.reshape(*x.shape[:-3], h, k, w, k, x.shape[-1]).mean(dim=(-4, -2))


# (dy, dx) of the neighbour each region is compared with
_SPA_OFFSETS_4 = {"left": (0, -1), "right": (0, 1), "up": (-1, 0), "down": (1, 0)}
_SPA_OFFSETS_8 = {"upleft": (-1, -1), "upright": (-1, 1),
                  "downleft": (1, -1), "downright": (1, 1)}
_SPA_OFFSETS_16 = {"left2": (0, -2), "right2": (0, 2), "up2": (-2, 0), "down2": (2, 0),
                   "up2left2": (-2, -2), "up2right2": (-2, 2),
                   "down2left2": (2, -2), "down2right2": (2, 2)}
_SPA_OFFSETS_24 = {"up2left1": (-2, -1), "up2right1": (-2, 1),
                   "up1left2": (-1, -2), "up1right2": (-1, 2),
                   "down2left1": (2, -1), "down2right1": (2, 1),
                   "down1left2": (1, -2), "down1right2": (1, 2)}


def _neighbor_diff(pooled: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """centre - the zero-padded neighbour at (dy, dx), over (..., H, W, C)."""
    pad = max(abs(dy), abs(dx))
    p = torch.nn.functional.pad(pooled, (0, 0, pad, pad, pad, pad))
    h, w = pooled.shape[-3], pooled.shape[-2]
    return pooled - p[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w, :]


@LOSSES.register(name="spatial_consistency_loss")
def spatial_consistency_loss(num_regions: int = 4, patch_size: int = 4,
                             loss_weight: float = 1.0, reduction: str = "mean"):
    """L_spa: the differences between neighbouring regions (the mean over
    channels, pooled patch_size x patch_size) of the input, kept in the
    enhanced image. ``num_regions`` in {4, 8, 16, 24}."""
    if num_regions not in (4, 8, 16, 24):
        raise ValueError(f"num_regions must be one of 4/8/16/24, got {num_regions}")
    offsets = dict(_SPA_OFFSETS_4)
    if num_regions in (8, 16):
        offsets.update(_SPA_OFFSETS_8)
    if num_regions in (16, 24):
        offsets.update(_SPA_OFFSETS_16)
    if num_regions == 24:
        offsets.update(_SPA_OFFSETS_24)
    offs = tuple(offsets.values())

    def fn(input, target, **_):
        org = _avg_pool(input.mean(dim=-1, keepdim=True), patch_size)
        enh = _avg_pool(target.mean(dim=-1, keepdim=True), patch_size)
        loss = 0.0
        for dy, dx in offs:
            d = _neighbor_diff(org, dy, dx) - _neighbor_diff(enh, dy, dx)
            loss = loss + d * d
        return loss_weight * reduce_loss(loss, reduction)
    return fn


@LOSSES.register(name="exposure_control_loss")
def exposure_control_loss(patch_size: int = 16, mean_val: float = 0.6,
                          loss_weight: float = 1.0, reduction: str = "mean"):
    """L_exp: the squared distance of each patch's mean intensity from ``mean_val``."""
    def fn(input, target=None, **_):
        mean = _avg_pool(input.mean(dim=-1, keepdim=True), patch_size)
        return loss_weight * reduce_loss((mean - mean_val) ** 2, reduction)
    return fn


@LOSSES.register(name="color_constancy_loss")
def color_constancy_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    """L_col: gray world, the channel means' pairwise squared distances."""
    def fn(input, target=None, **_):
        mean_rgb = input.mean(dim=(-3, -2), keepdim=True)
        mr, mg, mb = mean_rgb[..., 0], mean_rgb[..., 1], mean_rgb[..., 2]
        d_rg, d_rb, d_gb = (mr - mg) ** 2, (mr - mb) ** 2, (mb - mg) ** 2
        loss = torch.sqrt(d_rg ** 2 + d_rb ** 2 + d_gb ** 2 + 1e-12)
        return loss_weight * reduce_loss(loss, reduction)
    return fn


@LOSSES.register(name="total_variation_loss",
                 aliases=["tv_loss", "illumination_smoothness_loss"])
def total_variation_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    """L_tvA on a curve or illumination map: the squared forward differences
    along H and along W, each over its count, doubled, over the batch.
    (``reduction`` is accepted and, as in the JAX package, unused.)"""
    def fn(input, target=None, **_):
        x = input
        b = x.shape[0] if x.ndim == 4 else 1
        h_tv = ((x[..., 1:, :, :] - x[..., :-1, :, :]) ** 2).sum()
        w_tv = ((x[..., :, 1:, :] - x[..., :, :-1, :]) ** 2).sum()
        count_h = (x.shape[-3] - 1) * x.shape[-2] * x.shape[-1]
        count_w = x.shape[-3] * (x.shape[-2] - 1) * x.shape[-1]
        return loss_weight * 2.0 * (h_tv / count_h + w_tv / count_w) / b
    return fn
