"""Box and guided filters on NHWC images.

Port of ``box_filter_sum``, ``box_window_count``, ``box_filter``,
``guided_filter``, ``fast_guided_filter``, ``fast_guided_filter_bicubic``
and ``bilateral_blur`` from ``enhax/ops/filtering.py``: the window sum over
(2r+1)^2 pixels, truncated at the borders, as a difference of cumulative
sums along H and then W; the guided filter fits y ~ a x + b in every
window; the fast guided filter fits its linear model at low resolution and
applies it, upsampled, at high resolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from enhax_torch.ops.resize import resize, resize_bicubic_torch


def _window_sum_1d(v: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """out[i] = sum of v[j] over |i - j| <= r along ``dim``, border-truncated:
    with c the cumsum, c[min(i+r, n-1)] - (c[i-r-1] if i > r else 0)."""
    n = v.shape[dim]
    r = min(radius, n - 1)
    c = torch.cumsum(v, dim=dim)
    tail = list(c.shape)
    tail[dim] = r
    out = torch.cat([c.narrow(dim, r, n - r), c.narrow(dim, n - 1, 1).expand(tail)], dim=dim)
    if radius + 1 < n:
        out.narrow(dim, radius + 1, n - radius - 1).sub_(c.narrow(dim, 0, n - radius - 1))
    return out


def box_filter_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window, truncated at the borders; (..., H, W, C)."""
    r = int(radius)
    return _window_sum_1d(_window_sum_1d(x, r, x.ndim - 3), r, x.ndim - 2)


def box_window_count(shape_hw: tuple[int, int], radius: int,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Pixels in each border-truncated window, (H, W, 1)."""
    h, w = shape_hw
    r = int(radius)

    def span(n):
        i = torch.arange(n, device=device)
        return torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1

    return (span(h)[:, None] * span(w)[None, :]).to(dtype)[..., None]


def box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Window mean with border-truncated windows."""
    n = box_window_count((x.shape[-3], x.shape[-2]), radius, x.dtype, x.device)
    return box_filter_sum(x, radius) / n


def guided_filter(image: torch.Tensor, guide: torch.Tensor, radius: int = 1,
                  eps: float = 1e-8) -> torch.Tensor:
    """Edge-preserving guided filter: ``image`` filtered with ``guide``'s
    structure, channel by channel, at full resolution."""
    x, y = guide, image
    n = box_window_count((x.shape[-3], x.shape[-2]), radius, x.dtype, x.device)
    mean_x = box_filter_sum(x, radius) / n
    mean_y = box_filter_sum(y, radius) / n
    cov_xy = box_filter_sum(x * y, radius) / n - mean_x * mean_y
    var_x = box_filter_sum(x * x, radius) / n - mean_x * mean_x
    a = cov_xy / (var_x + eps)
    b = mean_y - a * mean_x
    return box_filter_sum(a, radius) / n * x + box_filter_sum(b, radius) / n


def _guided_coefficients(x_lr: torch.Tensor, y_lr: torch.Tensor, radius: int,
                         eps: float) -> tuple:
    """The guided filter's (a, b) at low resolution: y ~ a * x + b in each
    window. The window sums and moments are taken in float64 (the inputs
    are low-resolution): in float32 the running sums' rounding, over a row
    of 256, and the cancellation in E[xy] - E[x]E[y] reach the output at
    ~1e-3 (the JAX package's float32 result is that far from a float64
    evaluation of the same formula)."""
    dtype = x_lr.dtype
    x, y = x_lr.double(), y_lr.double()
    n = box_window_count((x.shape[-3], x.shape[-2]), radius, x.dtype, x.device)
    mean_x = box_filter_sum(x, radius) / n
    mean_y = box_filter_sum(y, radius) / n
    cov_xy = box_filter_sum(x * y, radius) / n - mean_x * mean_y
    var_x = box_filter_sum(x * x, radius) / n - mean_x * mean_x
    a = cov_xy / (var_x + eps)
    return a.to(dtype), (mean_y - a * mean_x).to(dtype)


def fast_guided_filter(image_lr: torch.Tensor, guide_lr: torch.Tensor,
                       guide_hr: torch.Tensor, radius: int = 1,
                       eps: float = 1e-8) -> torch.Tensor:
    """FastGuidedFilter: (a, b) fitted at low resolution, upsampled
    bilinearly and applied to ``guide_hr``."""
    a, b = _guided_coefficients(guide_lr, image_lr, radius, eps)
    hr = (guide_hr.shape[-3], guide_hr.shape[-2])
    return resize(a, hr, method="bilinear") * guide_hr + resize(b, hr, method="bilinear")


def fast_guided_filter_bicubic(x_lr: torch.Tensor, y_lr: torch.Tensor, x_hr: torch.Tensor,
                               radius: int = 1, eps: float = 1e-8) -> torch.Tensor:
    """FastGuidedFilter with (a, b) upsampled by torch's bicubic,
    ``align_corners=True`` (Zero-DCE-V's, CoLIE's)."""
    a, b = _guided_coefficients(x_lr, y_lr, radius, eps)
    hr = (x_hr.shape[-3], x_hr.shape[-2])
    return (resize_bicubic_torch(a, hr, align_corners=True) * x_hr
            + resize_bicubic_torch(b, hr, align_corners=True))


def bilateral_blur(x: torch.Tensor, kernel_size: tuple = (3, 3), sigma_color: float = 0.5,
                   sigma_space: tuple = (1.5, 1.5)) -> torch.Tensor:
    """kornia's bilateral blur of (N, H, W, C): reflect padding, a Gaussian
    in space times exp(-0.5 (d / sigma_color)^2), d the L1 distance over
    channels, normalised by the weights' sum."""
    kh, kw = int(kernel_size[0]), int(kernel_size[1])
    ph, pw = kh // 2, kw // 2
    gy = np.exp(-0.5 * ((np.arange(kh) - ph) / float(sigma_space[0])) ** 2)
    gx = np.exp(-0.5 * ((np.arange(kw) - pw) / float(sigma_space[1])) ** 2)
    space = np.outer(gy, gx)
    space = (space / space.sum()).astype(np.float32)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode="reflect").permute(0, 2, 3, 1)
    h, w = x.shape[1], x.shape[2]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x[..., :1])
    for dy in range(kh):
        for dx in range(kw):
            nb = xp[:, dy:dy + h, dx:dx + w, :]
            dist = (nb - x).abs().sum(dim=-1, keepdim=True)
            wgt = float(space[dy, dx]) * torch.exp(-0.5 * (dist / sigma_color) ** 2)
            num = num + wgt * nb
            den = den + wgt
    return num / den
