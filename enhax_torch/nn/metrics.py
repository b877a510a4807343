"""Image quality metrics of the port (NHWC, values in [0, data_range]).

Port of ``psnr``, ``psnr_per_image`` and ``ssim`` from
``enhax/nn/metrics.py``. SSIM follows pytorch-msssim as the JAX package
does: a Gaussian window (11, 1.5), a *valid* separable filter (no padding),
k1 = 0.01, k2 = 0.03, everything in float32. ``ms_ssim`` and the rest come
with ROADMAP item 1.11.
"""

from __future__ import annotations

import numpy as np
import torch

from enhax_torch.constants import METRICS


def _gauss_1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter_valid(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable Gaussian filter, VALID, over H then W of (N, H, W, C): a
    sum of shifted slices in the window's order, as the JAX package sums."""
    size = win.shape[0]

    def conv_axis(v, dim):
        n = v.shape[dim] - size + 1
        out = 0.0
        for i in range(size):
            out = out + float(win[i]) * v.narrow(dim, i, n)
        return out

    return conv_axis(conv_axis(x, -3), -2)


@METRICS.register(name="psnr", aliases=["peak_signal_noise_ratio"])
def psnr(input, target, data_range: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """PSNR over the whole batch (one mse over every element)."""
    mse = ((input.float() - target.float()) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / (mse + eps))


def psnr_per_image(input, target, data_range: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """PSNR of each image: (N, H, W, C) -> (N,)."""
    mse = ((input - target) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / (mse + eps))


def _ssim_components(x, y, data_range, window_size, sigma, k):
    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    win = _gauss_1d(window_size, sigma)
    mu_x = _gaussian_filter_valid(x, win)
    mu_y = _gaussian_filter_valid(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _gaussian_filter_valid(x * x, win) - mu_xx
    sigma_yy = _gaussian_filter_valid(y * y, win) - mu_yy
    sigma_xy = _gaussian_filter_valid(x * y, win) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs, cs


@METRICS.register(name="ssim", aliases=["structural_similarity_index_measure"])
def ssim(input, target, data_range: float = 1.0, window_size: int = 11,
         sigma: float = 1.5, k: tuple = (0.01, 0.03),
         non_negative: bool = False) -> torch.Tensor:
    """Structural similarity, the mean of the SSIM map over the batch."""
    ssim_map, _ = _ssim_components(input.float(), target.float(), data_range,
                                   window_size, sigma, k)
    if non_negative:
        ssim_map = torch.relu(ssim_map)
    return ssim_map.mean()
