"""Extended image metrics of the port (NHWC, float32).

Port of ``enhax/nn/metrics_img.py``: ERGAS, PSNR-B, RASE, sliding-window
RMSE, SCC, the spectral angle mapper, the spectral and spatial distortion
indices, total variation, UIQI and VIF-p, under the JAX package's names and
aliases. Each reduces as the JAX package's does (the batch's mean, or one
sum over the batch where the JAX package sums), in the same order of
operations:

  * the sliding windows (``rmse_sw``, ``scc``) stack every stride-1 window
    of ``window_size`` x ``window_size`` as shifted slices, in the JAX
    package's order, and reduce over the stacked axis;
  * SCC's Laplacian high-pass is a per-channel 3x3 correlation with zero
    "same" padding (``F.conv2d`` with one group a channel);
  * UIQI is SSIM with c1 = c2 = 0 over the Gaussian window (11, 1.5), and
    VIF-p filters with ``enhax_torch.nn.metrics``' valid separable Gaussian.

``perceptual_path_length`` takes its latents from a ``torch.Generator``
seeded with ``seed`` where the JAX package splits a ``jax.random`` key, or
from ``latents=(z0, z1, t)`` given explicitly; the generator and the
similarity are passed in, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from enhax_torch.constants import METRICS
from enhax_torch.nn.metrics import _gauss_1d, _gaussian_filter_valid, _ssim_components

__all__ = [
    "ergas", "perceptual_path_length", "psnrb", "rase", "rmse_sw", "scc",
    "spectral_angle_mapper", "spatial_distortion_index",
    "spectral_distortion_index", "total_variation", "uiqi", "vif",
]


def _nhwc(x) -> torch.Tensor:
    x = torch.as_tensor(x).float()
    return x[None] if x.ndim == 3 else x


@METRICS.register(name="total_variation")
def total_variation(img, reduction: str = "mean") -> torch.Tensor:
    """Anisotropic TV: each image's sum of |dh| + |dw| over its channels,
    reduced over the batch (``mean``, ``sum``, or ``none``)."""
    x = _nhwc(img)
    dh = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs()
    dw = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs()
    per_image = dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3))
    if reduction == "sum":
        return per_image.sum()
    if reduction in (None, "none"):
        return per_image
    return per_image.mean()


@METRICS.register(name="spectral_angle_mapper", aliases=["sam"])
def spectral_angle_mapper(preds, target, eps: float = 1e-8) -> torch.Tensor:
    """The mean per-pixel angle (radians) between the channel vectors."""
    p, t = _nhwc(preds), _nhwc(target)
    dot = (p * t).sum(dim=-1)
    den = torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(t, dim=-1)
    cos = (dot / den.clamp_min(eps)).clamp(-1.0, 1.0)
    return torch.arccos(cos).mean()


@METRICS.register(name="ergas", aliases=["error_relative_global_dimensionless_synthesis"])
def ergas(preds, target, ratio: float = 4.0) -> torch.Tensor:
    """100 ratio sqrt(mean_c(RMSE_c^2 / mean(target_c)^2)) an image, the
    batch's mean."""
    p, t = _nhwc(preds), _nhwc(target)
    rmse_c2 = ((p - t) ** 2).mean(dim=(1, 2))              # (N, C)
    mu_c = t.mean(dim=(1, 2))                              # (N, C)
    per_image = 100.0 * ratio * torch.sqrt((rmse_c2 / (mu_c ** 2).clamp_min(1e-12)).mean(dim=1))
    return per_image.mean()


@METRICS.register(name="rase", aliases=["relative_average_spectral_error"])
def rase(preds, target) -> torch.Tensor:
    """100 / mean(target) sqrt(mean_c RMSE_c^2) an image, the batch's mean."""
    p, t = _nhwc(preds), _nhwc(target)
    rmse_c2 = ((p - t) ** 2).mean(dim=(1, 2))
    mu = t.mean(dim=(1, 2, 3))
    per_image = 100.0 / mu.clamp_min(1e-12) * torch.sqrt(rmse_c2.mean(dim=1))
    return per_image.mean()


def _sliding_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """(N, H', W', win * win, C): every stride-1 window as shifted slices,
    row by row."""
    n, h, w, c = x.shape
    cols = [x[:, i:i + h - win + 1, j:j + w - win + 1, :]
            for i in range(win) for j in range(win)]
    return torch.stack(cols, dim=3)


@METRICS.register(name="rmse_sw", aliases=["root_mean_squared_error_using_sliding_window"])
def rmse_sw(preds, target, window_size: int = 8) -> torch.Tensor:
    """The mean over sliding windows of each window's RMSE."""
    p, t = _nhwc(preds), _nhwc(target)
    se = _sliding_windows((p - t) ** 2, window_size)
    return torch.sqrt(se.mean(dim=3)).mean()


@METRICS.register(name="uiqi", aliases=["universal_image_quality_index"])
def uiqi(preds, target, window_size: int = 11, sigma: float = 1.5,
         eps: float = 1e-12) -> torch.Tensor:
    """The universal image quality index: SSIM with c1 = c2 = 0 over a
    Gaussian window."""
    p, t = _nhwc(preds), _nhwc(target)
    ssim_map, _ = _ssim_components(p, t, 1.0, window_size, sigma, (0.0, 0.0))
    return ssim_map.mean()


_LAPLACIAN = np.array([[-1.0, -1.0, -1.0],
                       [-1.0, 8.0, -1.0],
                       [-1.0, -1.0, -1.0]], np.float32)


def _conv2_same_zero(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """A 2D correlation of each channel with ``k``, zero "same" padding,
    on (N, H, W, C)."""
    kh, kw = k.shape
    c = x.shape[-1]
    kern = torch.from_numpy(k).to(x)[None, None].expand(c, 1, kh, kw)
    y = F.conv2d(x.permute(0, 3, 1, 2), kern, padding=(kh // 2, kw // 2), groups=c)
    return y.permute(0, 2, 3, 1)


@METRICS.register(name="scc", aliases=["spatial_correlation_coefficient"])
def scc(preds, target, window_size: int = 8) -> torch.Tensor:
    """Spatial correlation coefficient: both images Laplacian high-passed,
    then the mean windowed Pearson correlation (uniform windows, valid)."""
    p = _conv2_same_zero(_nhwc(preds), _LAPLACIAN)
    t = _conv2_same_zero(_nhwc(target), _LAPLACIAN)
    pw = _sliding_windows(p, window_size)
    tw = _sliding_windows(t, window_size)
    mu_p = pw.mean(dim=3, keepdim=True)
    mu_t = tw.mean(dim=3, keepdim=True)
    cov = ((pw - mu_p) * (tw - mu_t)).mean(dim=3)
    var_p = ((pw - mu_p) ** 2).mean(dim=3)
    var_t = ((tw - mu_t) ** 2).mean(dim=3)
    den = torch.sqrt(var_p * var_t)
    corr = torch.where(den > 0, cov / den.clamp_min(1e-12), 0.0)
    return corr.mean()


@METRICS.register(name="psnrb", aliases=["peak_signal_noise_ratio_with_blocked_effect"])
def psnrb(preds, target, data_range: float = 1.0, block_size: int = 8) -> torch.Tensor:
    """PSNR-B: 10 log10(range^2 / (MSE + BEF)), the blocking effect factor
    of the prediction's discontinuities across its block boundaries."""
    p, t = _nhwc(preds), _nhwc(target)
    mse = ((p - t) ** 2).mean()

    def bef(x):
        n, h, w, c = x.shape
        # column pairs (j, j + 1) on a boundary where (j + 1) % block == 0
        jmask = (torch.arange(w - 1, device=x.device) + 1) % block_size == 0
        dcol2 = ((x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2).mean(dim=(0, 1, 3))
        imask = (torch.arange(h - 1, device=x.device) + 1) % block_size == 0
        drow2 = ((x[:, 1:, :, :] - x[:, :-1, :, :]) ** 2).mean(dim=(0, 2, 3))
        d_b = (torch.where(jmask, dcol2, 0.0).sum() + torch.where(imask, drow2, 0.0).sum()) \
            / max(int(jmask.sum() + imask.sum()), 1)
        d_bc = (torch.where(~jmask, dcol2, 0.0).sum() + torch.where(~imask, drow2, 0.0).sum()) \
            / max(int((~jmask).sum() + (~imask).sum()), 1)
        eta = np.log2(float(block_size)) / np.log2(float(min(h, w)))
        return torch.where(d_b > d_bc, eta * (d_b - d_bc), torch.zeros_like(d_b))

    return 10.0 * torch.log10(data_range ** 2 / (mse + bef(p)).clamp_min(1e-12))


@METRICS.register(name="vif", aliases=["visual_information_fidelity", "vifp"])
def vif(preds, target, sigma_nsq: float = 2.0) -> torch.Tensor:
    """Pixel-domain visual information fidelity (VIF-p): four scales,
    Gaussian windows of N = 2^(5 - s) + 1 with sigma N / 5, the Gaussian
    scale mixture's gain and noise at each, summed over the batch and the
    channels. ``sigma_nsq`` = 2 assumes luminance in [0, 255]."""
    p, t = _nhwc(preds), _nhwc(target)
    eps = 1e-10
    num = 0.0
    den = 0.0
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        win = _gauss_1d(n, n / 5.0)
        if scale > 1:
            p = _gaussian_filter_valid(p, win)[:, ::2, ::2, :]
            t = _gaussian_filter_valid(t, win)[:, ::2, ::2, :]
        mu1 = _gaussian_filter_valid(t, win)
        mu2 = _gaussian_filter_valid(p, win)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _gaussian_filter_valid(t * t, win) - mu1_sq
        sigma2_sq = _gaussian_filter_valid(p * p, win) - mu2_sq
        sigma12 = _gaussian_filter_valid(t * p, win) - mu1_mu2
        sigma1_sq = sigma1_sq.clamp_min(0.0)
        sigma2_sq = sigma2_sq.clamp_min(0.0)
        g = sigma12 / (sigma1_sq + eps)
        sv_sq = sigma2_sq - g * sigma12
        g = torch.where(sigma1_sq < eps, 0.0, g)
        sv_sq = torch.where(sigma1_sq < eps, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(sigma1_sq < eps, 0.0, sigma1_sq)
        sv_sq = torch.where(sigma2_sq < eps, 0.0, sv_sq)
        g = torch.where(sigma2_sq < eps, 0.0, g)
        sv_sq = torch.where(g < 0, sigma2_sq, sv_sq)
        g = g.clamp_min(0.0)
        sv_sq = sv_sq.clamp_min(eps)
        num = num + torch.log10(1.0 + g * g * sigma1_sq / (sv_sq + sigma_nsq)).sum()
        den = den + torch.log10(1.0 + sigma1_sq / sigma_nsq).sum()
    return num / den.clamp_min(1e-12)


@METRICS.register(name="spectral_distortion_index", aliases=["d_lambda"])
def spectral_distortion_index(preds, ms, p: int = 1, window_size: int = 11) -> torch.Tensor:
    """D_lambda: the mean over distinct band pairs of |Q(pred_l, pred_r) -
    Q(ms_l, ms_r)|^p, to the power 1/p."""
    pr, m = _nhwc(preds), _nhwc(ms)
    c = pr.shape[-1]
    diffs = []
    for l in range(c):
        for r in range(c):
            if l == r:
                continue
            q_p = uiqi(pr[..., l:l + 1], pr[..., r:r + 1], window_size)
            q_m = uiqi(m[..., l:l + 1], m[..., r:r + 1], window_size)
            diffs.append((q_p - q_m).abs() ** p)
    return torch.stack(diffs).mean() ** (1.0 / p)


@METRICS.register(name="spatial_distortion_index", aliases=["d_s"])
def spatial_distortion_index(preds, ms, pan, pan_lr=None, q: int = 1,
                             window_size: int = 7) -> torch.Tensor:
    """D_s: the mean over bands of |Q(pred_c, pan) - Q(ms_c, pan_lr)|^q, to
    the power 1/q; ``pan_lr`` defaults to ``pan`` average-pooled to the
    ms resolution."""
    pr, m = _nhwc(preds), _nhwc(ms)
    pan = _nhwc(pan)
    if pan_lr is None:
        fy = pan.shape[1] // m.shape[1]
        fx = pan.shape[2] // m.shape[2]
        n, h, w, c = pan.shape
        pan_lr = pan[:, : m.shape[1] * fy, : m.shape[2] * fx, :].reshape(
            n, m.shape[1], fy, m.shape[2], fx, c).mean(dim=(2, 4))
    else:
        pan_lr = _nhwc(pan_lr)
    diffs = []
    for l in range(pr.shape[-1]):
        q_hi = uiqi(pr[..., l:l + 1], pan, window_size)
        q_lo = uiqi(m[..., l:l + 1], pan_lr, window_size)
        diffs.append((q_hi - q_lo).abs() ** q)
    return torch.stack(diffs).mean() ** (1.0 / q)


def _slerp(z0: torch.Tensor, z1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between latent rows; a lerp where the
    endpoints are (anti)parallel."""
    z0n = z0 / torch.linalg.vector_norm(z0, dim=-1, keepdim=True)
    z1n = z1 / torch.linalg.vector_norm(z1, dim=-1, keepdim=True)
    omega = torch.arccos((z0n * z1n).sum(dim=-1, keepdim=True).clamp(-1.0, 1.0))
    so = torch.sin(omega)
    safe = so.abs() > 1e-7
    div = torch.where(safe, so, 1.0)
    sl = (torch.sin((1.0 - t) * omega) / div) * z0 + (torch.sin(t * omega) / div) * z1
    return torch.where(safe, sl, (1.0 - t) * z0 + t * z1)


@METRICS.register(name="perceptual_path_length", aliases=["ppl"])
def perceptual_path_length(generator, z_size: int, similarity, num_samples: int = 256,
                           batch_size: int = 64, interpolation: str = "lerp",
                           epsilon: float = 1e-4, sample_mode: str = "full",
                           lower_discard: float | None = 0.01,
                           upper_discard: float | None = 0.99, seed: int = 0,
                           latents: tuple | None = None) -> tuple:
    """Perceptual path length of a generator (the StyleGAN metric):
    latent pairs, the interpolation coordinate perturbed by ``epsilon``,
    ``similarity(img_t, img_t+eps) / epsilon**2`` a pair; the distances
    beyond the discard quantiles dropped. ``generator(z) -> (N, H, W, C)``
    and ``similarity(a, b) -> (N,)`` are passed in. The latents (z0, z1,
    and t of shape (num_samples, 1)) are ``latents`` (in their own dtype)
    or drawn in float32 from a ``torch.Generator`` seeded with ``seed``.
    Returns ``(mean, std, distances)``."""
    if sample_mode not in ("full", "end"):
        raise ValueError(f"sample_mode must be full|end, got {sample_mode}")
    if interpolation not in ("lerp", "slerp"):
        raise ValueError(f"interpolation must be lerp|slerp, got {interpolation}")
    if latents is None:
        rng = torch.Generator().manual_seed(seed)
        z0 = torch.randn(num_samples, z_size, generator=rng)
        z1 = torch.randn(num_samples, z_size, generator=rng)
        t = (torch.rand(num_samples, 1, generator=rng) if sample_mode == "full"
             else torch.zeros(num_samples, 1))
    else:
        z0, z1, t = (torch.as_tensor(np.array(a)) for a in latents)
        if sample_mode == "end":
            t = torch.zeros_like(t)
    interp = _slerp if interpolation == "slerp" else (lambda a, b, tt: a + tt * (b - a))
    dists = []
    for i in range(0, num_samples, batch_size):
        sl = slice(i, i + batch_size)
        a = interp(z0[sl], z1[sl], t[sl])
        b = interp(z0[sl], z1[sl], t[sl] + epsilon)
        d = torch.as_tensor(similarity(generator(a), generator(b)))
        dists.append(d.reshape(-1) / (epsilon ** 2))
    dists = torch.cat(dists)
    kept = dists
    if lower_discard is not None:
        kept = kept[kept >= torch.quantile(dists, lower_discard)]
    if upper_discard is not None:
        kept = kept[kept <= torch.quantile(dists, upper_discard)]
    return float(kept.mean()), float(kept.std(correction=0)), dists.cpu().numpy()
