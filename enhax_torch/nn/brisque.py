"""BRISQUE no-reference image quality, in PyTorch.

Port of ``enhax/nn/brisque.py`` (Mittal et al., TIP 2012): 36 natural-scene
features (18 a scale over two scales) from MSCN coefficients,

  * MSCN: (I - mu) / (sigma + 1), Gaussian-weighted local moments (7x7,
    sigma 7/6) with reflect padding;
  * the GGD fit (alpha, sigma^2) of the whole MSCN map and the AGGD fits
    (alpha, mean, left and right variance) of its four pair products (H,
    V, D1, D2, each map rolled whole);
  * the half scale by ``jax.image.resize``'s antialiased linear resize.

Unlike NIQE's, the moment-ratio tables are scipy's ``gamma`` in float64
cast to float32, matched by squared difference, and the AGGD mean takes
the gamma values at the chosen grid point from the same float64 tables.

``brisque_score`` is libsvm's RBF-SVR: the features scaled to [-1, 1] by
the model's ranges, sum(coef exp(-gamma |sv - f|^2)) - rho. Without an SVM
``brisque`` returns the features' mean norm, a proxy and not the
calibrated score, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from enhax_torch.constants import METRICS


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device) -> dict:
    """The grid [0.2, 10] in steps of 0.001 and scipy's float64 tables on
    it, cast to float32 on ``device`` once a device: the GGD ratio G(1/a)
    G(3/a) / G(2/a)^2, the AGGD ratio G(2/a)^2 / (G(1/a) G(3/a)), and
    G(1/a), G(2/a), G(3/a)."""
    from scipy.special import gamma
    gam = np.arange(0.2, 10.001, 0.001)
    g1, g2, g3 = gamma(1.0 / gam), gamma(2.0 / gam), gamma(3.0 / gam)
    arrays = {"gam": gam, "ggd": g1 * g3 / g2 ** 2, "aggd": g2 ** 2 / (g1 * g3),
              "g1": g1, "g2": g2, "g3": g3}
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def _gaussian_kernel(size: int = 7, sigma: float = 7.0 / 6.0, device=None) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(r ** 2) / (2 * sigma ** 2))
    g2 = g[:, None] * g[None, :]
    return g2 / g2.sum()


def _local_moments(x: torch.Tensor, k: torch.Tensor) -> tuple:
    """Gaussian-weighted local mean and std with reflect padding; x (H, W)."""
    p = k.shape[0] // 2
    xp = F.pad(x[None, None], (p,) * 4, mode="reflect")
    mu = F.conv2d(xp, k[None, None])[0, 0]
    sigma = torch.sqrt((F.conv2d(xp * xp, k[None, None])[0, 0] - mu * mu).clamp_min(0.0))
    return mu, sigma


def _ggd_fit(x: torch.Tensor) -> tuple:
    """Generalised Gaussian (alpha, sigma^2) by moment matching."""
    t = _tables(x.device)
    sigma_sq = (x ** 2).mean()
    e_abs = x.abs().mean()
    rho = sigma_sq / (e_abs ** 2).clamp_min(1e-12)
    idx = torch.argmin((t["ggd"] - rho) ** 2)
    return t["gam"][idx], sigma_sq


def _aggd_fit(x: torch.Tensor) -> tuple:
    """Asymmetric GGD: (alpha, mean, left variance, right variance)."""
    t = _tables(x.device)
    mask_l = x < 0
    mask_r = x > 0
    cnt_l = mask_l.sum().clamp_min(1)
    cnt_r = mask_r.sum().clamp_min(1)
    l_std = torch.sqrt(torch.where(mask_l, x * x, 0.0).sum() / cnt_l)
    r_std = torch.sqrt(torch.where(mask_r, x * x, 0.0).sum() / cnt_r)
    gamma_hat = l_std / r_std.clamp_min(1e-12)
    e_abs = x.abs().mean()
    rho = e_abs ** 2 / (x ** 2).mean().clamp_min(1e-12)
    rhat = rho * (gamma_hat ** 3 + 1) * (gamma_hat + 1) \
        / ((gamma_hat ** 2 + 1) ** 2).clamp_min(1e-12)
    idx = torch.argmin((t["aggd"] - rhat) ** 2)
    g1, g2, g3 = t["g1"][idx], t["g2"][idx], t["g3"][idx]
    mean = (r_std - l_std) * (g2 / g1) * torch.sqrt(g1 / g3)
    return t["gam"][idx], mean, l_std ** 2, r_std ** 2


def _scale_features(gray: torch.Tensor) -> torch.Tensor:
    mu, sigma = _local_moments(gray, _gaussian_kernel(device=gray.device))
    mscn = (gray - mu) / (sigma + 1.0)
    feats = list(_ggd_fit(mscn))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = mscn * torch.roll(mscn, shifts=(-dy, -dx), dims=(0, 1))
        feats.extend(_aggd_fit(prod))
    return torch.stack(feats)


def brisque_features(image) -> torch.Tensor:
    """36 BRISQUE features of one (H, W, C) or (H, W) image in [0, 1]."""
    from enhax_torch.ops.resize import resize
    x = torch.as_tensor(image).float()
    if x.ndim == 3:
        x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    x = x * 255.0
    f1 = _scale_features(x)
    h, w = x.shape
    half = resize(x[..., None], (h // 2, w // 2), method="linear", antialias=True)[..., 0]
    return torch.cat([f1, _scale_features(half)])


def brisque_score(features, svm: dict) -> torch.Tensor:
    """libsvm's RBF-SVR score of the features. ``svm``: "sv" (N, 36)
    support vectors, "coef" (N,), "rho", "gamma", and "lo" / "hi" (36,),
    the features' scaling ranges."""
    f = torch.as_tensor(features)
    # float32 throughout, as the JAX package computes (an .npz's float64
    # arrays become float32 there)
    s = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=f.device)
         for k, v in svm.items()}
    f = (f - s["lo"]) / (s["hi"] - s["lo"])
    f = -1.0 + 2.0 * f   # libsvm's [-1, 1] scaling
    d = ((s["sv"] - f[None, :]) ** 2).sum(dim=-1)
    return (s["coef"] * torch.exp(-s["gamma"] * d)).sum() - s["rho"]


@METRICS.register(name="brisque")
def brisque(input, svm: dict | None = None, **_) -> torch.Tensor:
    """The batch's mean BRISQUE. Without an ``svm`` dict, the mean norm of
    the features: a proxy with no weights, NOT the calibrated score."""
    x = torch.as_tensor(input)
    if x.ndim == 3:
        x = x[None]
    feats = torch.stack([brisque_features(img) for img in x])
    if svm is None:
        return torch.linalg.vector_norm(feats, dim=-1).mean()
    return torch.stack([brisque_score(f, svm) for f in feats]).mean()
