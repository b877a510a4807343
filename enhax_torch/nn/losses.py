"""Losses of the port (NHWC images in [0, 1]).

Port of ``reduce_loss``, the pixel losses (``l1_loss``, ``l2_loss``,
``charbonnier_loss``, ``smooth_l1_loss``), ``psnr_loss``, ``ssim_loss``,
``ms_ssim_loss``, Zero-DCE's zero-reference losses (spatial consistency,
exposure control, colour constancy, total variation) and the instance
models' (exposure value control, edge-aware depth consistency, edge-aware,
depth-weighted smoothness), those of the low-light families (edge,
colour, histogram, perceptual) and MPRNet's ``edge_charbonnier_loss`` from
``enhax/nn/losses.py``. A registered entry is a constructor:
``LOSSES.build(name, **params)`` returns ``loss(input, target) -> scalar``.
The other losses of the JAX package come with the models that train on
them (ROADMAP item 1.15f).
"""

from __future__ import annotations

import functools
import math

import torch

from enhax_torch.constants import LOSSES
from enhax_torch.nn.metrics import ms_ssim, ssim

_Y_COEF = (65.481, 128.553, 24.966)


def reduce_loss(loss: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@LOSSES.register(name="l1_loss", aliases=["mae_loss"])
def l1_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    def fn(input, target, **_):
        return loss_weight * reduce_loss((input - target).abs(), reduction)
    return fn


@LOSSES.register(name="l2_loss", aliases=["mse_loss"])
def l2_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    def fn(input, target, **_):
        return loss_weight * reduce_loss((input - target) ** 2, reduction)
    return fn


@LOSSES.register(name="charbonnier_loss")
def charbonnier_loss(eps: float = 1e-3, loss_weight: float = 1.0, reduction: str = "mean"):
    """sqrt(diff^2 + eps^2)."""
    def fn(input, target, **_):
        return loss_weight * reduce_loss(torch.sqrt((input - target) ** 2 + eps * eps),
                                         reduction)
    return fn


@LOSSES.register(name="smooth_l1_loss", aliases=["smooth_mae_loss"])
def smooth_l1_loss(beta: float = 1.0, loss_weight: float = 1.0, reduction: str = "mean"):
    def fn(input, target, **_):
        d = (input - target).abs()
        return loss_weight * reduce_loss(
            torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta), reduction)
    return fn


@LOSSES.register(name="ssim_loss")
def ssim_loss(data_range: float = 1.0, window_size: int = 11, window_sigma: float = 1.5,
              k: tuple = (0.01, 0.03), loss_weight: float = 1.0, reduction: str = "mean"):
    """1 - SSIM."""
    def fn(input, target, **_):
        s = ssim(input, target, data_range=data_range, window_size=window_size,
                 sigma=window_sigma, k=k)
        return loss_weight * reduce_loss(1.0 - s, reduction)
    return fn


@LOSSES.register(name="ms_ssim_loss")
def ms_ssim_loss(data_range: float = 1.0, window_size: int = 11, window_sigma: float = 1.5,
                 weights: tuple | None = None, k: tuple = (0.01, 0.03),
                 loss_weight: float = 1.0, reduction: str = "mean"):
    """1 - MS-SSIM."""
    def fn(input, target, **_):
        s = ms_ssim(input, target, data_range=data_range, window_size=window_size,
                    sigma=window_sigma, weights=weights, k=k)
        return loss_weight * reduce_loss(1.0 - s, reduction)
    return fn


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


@LOSSES.register(name="exposure_value_control_loss")
def exposure_value_control_loss(patch_size: int = 16, mean_val: float = 0.6,
                                loss_weight: float = 1.0, reduction: str = "mean"):
    """L_exp on the square root of the pooled intensity:
    (sqrt(avgpool(mean_c(x))) - mean_val)^2."""
    def fn(input, target=None, **_):
        pooled = _avg_pool(input.mean(dim=-1, keepdim=True), patch_size)
        mean = torch.sqrt(pooled.clamp_min(0.0))
        return loss_weight * reduce_loss((mean - mean_val) ** 2, reduction)
    return fn


_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _sobel_zero(x: torch.Tensor) -> tuple:
    """Sobel responses of (N, H, W, C) with zero padding, per channel."""
    h, w = x.shape[-3], x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    gx = gy = 0.0
    for i in range(3):
        for j in range(3):
            patch = xp[..., i:i + h, j:j + w, :]
            gx = gx + _SOBEL_X[i][j] * patch
            gy = gy + _SOBEL_Y[i][j] * patch
    return gx, gy


@LOSSES.register(name="edge_aware_depth_consistency_loss")
def edge_aware_depth_consistency_loss(tau: float = 0.1, loss_weight: float = 1.0,
                                      reduction: str = "mean"):
    """The image's squared gradients where the depth has strong edges:
    mean(mask * (gx^2 + gy^2)), mask = |sobel(depth)| > tau."""
    def fn(input, depth, **_):
        dx, dy = _sobel_zero(depth)
        mask = (torch.sqrt(dx ** 2 + dy ** 2) > tau).to(input.dtype)
        gx, gy = _sobel_zero(input)
        return loss_weight * (mask * (gx ** 2 + gy ** 2)).mean()
    return fn


def _forward_diffs(x: torch.Tensor) -> tuple:
    return x[..., :, 1:, :] - x[..., :, :-1, :], x[..., 1:, :, :] - x[..., :-1, :, :]


@LOSSES.register(name="edge_aware_loss")
def edge_aware_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    """Illumination gradients weighted by exp(-|edge gradients|)."""
    def fn(input, edge, **_):
        l_dx, l_dy = _forward_diffs(input)
        e_dx, e_dy = _forward_diffs(edge)
        return loss_weight * ((torch.exp(-e_dx.abs()) * l_dx.abs()).mean()
                              + (torch.exp(-e_dy.abs()) * l_dy.abs()).mean())
    return fn


@LOSSES.register(name="depth_weighted_smoothness_loss")
def depth_weighted_smoothness_loss(alpha: float = 1.0, loss_weight: float = 1.0,
                                   reduction: str = "mean"):
    """Illumination gradients weighted by exp(-alpha |depth gradients|)."""
    def fn(input, depth, **_):
        l_dx, l_dy = _forward_diffs(input)
        d_dx, d_dy = _forward_diffs(depth)
        return loss_weight * ((torch.exp(-alpha * d_dx.abs()) * l_dx.abs()).mean()
                              + (torch.exp(-alpha * d_dy.abs()) * l_dy.abs()).mean())
    return fn


_GAUSS_1D = (0.05, 0.25, 0.4, 0.25, 0.05)


def _gauss_blur5(x: torch.Tensor) -> torch.Tensor:
    """5x5 separable blur of (..., H, W, C) with replicate padding, over H
    then W, each a sum of shifted slices in the kernel's order."""

    def conv_axis(v, dim):
        n = v.shape[dim]
        vp = torch.cat([v.narrow(dim, 0, 1)] * 2 + [v] + [v.narrow(dim, n - 1, 1)] * 2, dim)
        out = 0.0
        for i, k in enumerate(_GAUSS_1D):
            out = out + k * vp.narrow(dim, i, n)
        return out

    return conv_axis(conv_axis(x, -3), -2)


def _laplacian_pyramid_residual(x: torch.Tensor) -> torch.Tensor:
    """image - blur(upsample(downsample(blur(image)))): the blurred image's
    even pixels times 4 on a zero grid, blurred again."""
    filtered = _gauss_blur5(x)
    up = torch.zeros_like(filtered)
    up[..., ::2, ::2, :] = filtered[..., ::2, ::2, :] * 4.0
    return x - _gauss_blur5(up)


@LOSSES.register(name="edge_loss")
def edge_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    """Charbonnier on the Laplacian residuals of input and target."""
    char = charbonnier_loss(reduction=reduction)

    def fn(input, target, **_):
        return loss_weight * char(_laplacian_pyramid_residual(input),
                                  _laplacian_pyramid_residual(target))
    return fn


@LOSSES.register(name="edge_charbonnier_loss")
def edge_charbonnier_loss(edge_loss_weight: float = 1.0, char_loss_weight: float = 1.0,
                          loss_weight: float = 1.0, reduction: str = "mean"):
    """char_w * Charbonnier + edge_w * ``edge_loss`` (MPRNet's loss)."""
    edge = edge_loss(reduction=reduction)
    char = charbonnier_loss(reduction=reduction)

    def fn(input, target, **_):
        return loss_weight * (char_loss_weight * char(input, target)
                              + edge_loss_weight * edge(input, target))
    return fn


@LOSSES.register(name="color_loss")
def color_loss(loss_weight: float = 1.0, reduction: str = "mean"):
    """|mean(input) - mean(target)| per image, averaged over the batch.
    (``reduction`` is accepted and, as in the JAX package, unused.)"""
    def fn(input, target, **_):
        mi = input.mean(dim=tuple(range(1, input.ndim)))
        mt = target.mean(dim=tuple(range(1, target.ndim)))
        return loss_weight * (mi - mt).abs().mean()
    return fn


@LOSSES.register(name="histogram_loss")
def histogram_loss(bins: int = 256, sigma: float = 0.01, loss_weight: float = 1.0,
                   reduction: str = "mean"):
    """L1 between soft histograms: every value of the batch, flattened,
    against ``bins`` Gaussian bins centred on linspace(0, 1), summed and
    normalised; one (values, bins) tensor."""
    def soft_hist(x):
        edges = torch.linspace(0.0, 1.0, bins, dtype=x.dtype, device=x.device)
        h = torch.exp(-0.5 * ((x.reshape(-1, 1) - edges) / sigma) ** 2).sum(0)
        return h / h.sum().clamp_min(1e-12)

    def fn(input, target, **_):
        return loss_weight * (soft_hist(target) - soft_hist(input)).abs().mean()
    return fn


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _pool_pyramid(x: torch.Tensor) -> list:
    """The default perceptual features, weight-free: three 2x2 average
    pools in turn."""
    feats = []
    for _ in range(3):
        x = _avg_pool(x, 2)
        feats.append(x)
    return feats


@LOSSES.register(name="perceptual_loss")
def perceptual_loss(feature_fn=None, preprocess: bool = False, loss_weight: float = 1.0,
                    reduction: str = "mean"):
    """Feature-space L1, averaged over the features of ``feature_fn(x) ->
    list``; by default the average-pool pyramid. ``preprocess`` normalises
    by ImageNet's mean and std first."""
    feature_fn = feature_fn or _pool_pyramid

    def fn(input, target, **_):
        if preprocess:
            mean = input.new_tensor(_IMAGENET_MEAN)
            std = input.new_tensor(_IMAGENET_STD)
            input, target = (input - mean) / std, (target - mean) / std
        fx, fy = feature_fn(input), feature_fn(target)
        loss = functools.reduce(lambda acc, p: acc + (p[0] - p[1]).abs().mean(),
                                zip(fx, fy), 0.0) / len(fx)
        return loss_weight * loss
    return fn
