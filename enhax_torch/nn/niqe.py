"""NIQE: the Natural Image Quality Evaluator (no reference), in PyTorch.

Port of ``enhax/nn/niqe.py`` (Mittal et al., "Making a 'Completely Blind'
Image Quality Analyzer", SPL 2013):

- ``niqe_features``: 36 natural-scene-statistics features a patch (96 px
  at scale 1, 48 px at the half scale) and the sharpness mask (a patch's
  mean local sigma above 0.75 x the largest).
- ``fit_niqe_params``: the pristine multivariate Gaussian of a local set of
  high-quality images (``impl="self"``).
- ``load_niqe_params``: ``.npz`` files in both layouts (fitted ``mu``/
  ``cov``, or BasicSR's ``niqe_pris_params.npz``: ``mu_pris_param``,
  ``cov_pris_param``, ``gaussian_window``) and the MATLAB release's
  ``.mat`` through ``scipy.io`` (``impl="official"``).
- ``niqe`` / ``make_niqe``: a score against a params dict, dispatched on
  ``impl``; ``niqe_official``: the official (BasicSR) pipeline.

The self pipeline, as the JAX package's: reflect-padded 7x7 Gaussian
(sigma 7/6) MSCN; the moment-ratio lookups take an argmin over a float32
grid ``arange(0.2, 10.001, 0.001)`` whose tables are float32 ``lgamma``
then ``exp``, in the JAX package's order (``torch.lgamma`` and XLA's part
by up to ~1e-5 relative, so a fit near a tie of two grid points can take
the neighbour: a shape parameter differs by one grid step, 0.001); the half
scale is ``jax.image.resize``'s antialiased linear resize
(``enhax_torch.ops.resize.resize(..., antialias=True)``); the pair products
roll the whole map; the MVG moments are weighted by the mask, and the score
takes a float32 pseudo-inverse with the JAX package's cut-off, singular
values below 10 x max(m, n) x eps(float32) x the largest.

The official pipeline: replicate-padded MSCN with the params' window, AGGD
fits in the (alpha, beta_l, beta_r) form (a block with no negative or no
positive sample gives NaN, and alpha the first grid value), pair products
that wrap within each block, the BT.601 studio-swing Y channel and a 2x2
average half scale; the features in float32 on the image's device but for
the MSCN's window moments, which are float64 (on the Y channel's scale
float32 cancels in E[x^2] - mu^2: the JAX package's float32 score lies up
to 3.5e-3 from its own float64 run, the port's 5.6e-5), the MVG statistics
and the pseudo-inverse in float64 numpy on the host.

Features run on the image's device.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from enhax_torch.constants import METRICS


def _gamma(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.lgamma(x))


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device) -> tuple:
    """(grid, GGD rho(g) = G(1/g) G(3/g) / G(2/g)^2, AGGD r(a) = G(2/a)^2 /
    (G(1/a) G(3/a))) on ``device``, float32, built once a device."""
    grid = torch.from_numpy(np.arange(0.2, 10.001, 0.001, dtype=np.float32)).to(device)
    ggd = _gamma(1.0 / grid) * _gamma(3.0 / grid) / _gamma(2.0 / grid) ** 2
    aggd = _gamma(2.0 / grid) ** 2 / (_gamma(1.0 / grid) * _gamma(3.0 / grid))
    return grid, ggd, aggd


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0, device=None) -> torch.Tensor:
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = torch.outer(g, g)
    return k / k.sum()


def _conv_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2D correlation of an (H, W) map, VALID."""
    return F.conv2d(x[None, None], kernel[None, None])[0, 0]


def _filter2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2D correlation with reflect padding, SAME output (img: (H, W))."""
    p = kernel.shape[0] // 2
    return _conv_valid(F.pad(img[None, None], (p,) * 4, mode="reflect")[0, 0], kernel)


def _mscn(gray: torch.Tensor) -> tuple:
    """Mean-subtracted contrast-normalised coefficients and the local
    sigma."""
    win = _gaussian_window(device=gray.device)
    mu = _filter2(gray, win)
    sigma = torch.sqrt((_filter2(gray * gray, win) - mu * mu).clamp_min(0.0))
    return (gray - mu) / (sigma + 1.0), sigma


def _ggd_fit(x: torch.Tensor, dim) -> tuple:
    """Generalised Gaussian by moment matching -> (alpha, sigma_sq)."""
    grid, ggd, _ = _tables(x.device)
    sigma_sq = (x ** 2).mean(dim=dim)
    e_abs = x.abs().mean(dim=dim)
    rho = sigma_sq / (e_abs ** 2).clamp_min(1e-12)
    idx = torch.argmin((rho[..., None] - ggd).abs(), dim=-1)
    return grid[idx], sigma_sq


def _aggd_fit(x: torch.Tensor, dim) -> tuple:
    """Asymmetric GGD -> (alpha, mean, left_var, right_var)."""
    grid, _, aggd = _tables(x.device)
    neg = (x < 0).to(x.dtype)
    pos = (x > 0).to(x.dtype)
    cnt_l = neg.sum(dim=dim).clamp_min(1.0)
    cnt_r = pos.sum(dim=dim).clamp_min(1.0)
    left_sq = ((x * neg) ** 2).sum(dim=dim) / cnt_l
    right_sq = ((x * pos) ** 2).sum(dim=dim) / cnt_r
    l_std = torch.sqrt(left_sq)
    r_std = torch.sqrt(right_sq)
    gammahat = l_std / r_std.clamp_min(1e-12)
    rhat = x.abs().mean(dim=dim) ** 2 / (x ** 2).mean(dim=dim).clamp_min(1e-12)
    rhatnorm = rhat * (gammahat ** 3 + 1) * (gammahat + 1) \
        / ((gammahat ** 2 + 1) ** 2).clamp_min(1e-12)
    idx = torch.argmin((rhatnorm[..., None] - aggd).abs(), dim=-1)
    alpha = grid[idx]
    const = torch.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    mean = (r_std - l_std) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha)) * const
    return alpha, mean, left_sq, right_sq


def _patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """(H, W) -> (P, patch, patch); H, W multiples of patch."""
    h, w = img.shape
    return img.reshape(h // patch, patch, w // patch, patch).permute(0, 2, 1, 3).reshape(
        -1, patch, patch)


def _scale_features(mscn: torch.Tensor, patch: int) -> torch.Tensor:
    """18 features a patch at one scale -> (P, 18)."""
    feats = list(_ggd_fit(_patchify(mscn, patch), dim=(-2, -1)))
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):   # H, V, D1, D2 products
        prod = mscn * torch.roll(mscn, shifts=(-dy, -dx), dims=(0, 1))
        feats.extend(_aggd_fit(_patchify(prod, patch), dim=(-2, -1)))
    return torch.stack(feats, dim=-1)


def _image(image) -> torch.Tensor:
    image = torch.as_tensor(image).float()
    return image[0] if image.ndim == 4 else image


def _to_gray(image) -> torch.Tensor:
    image = _image(image)
    if image.ndim == 3:
        image = 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]
    return image * 255.0


def niqe_features(image, patch: int = 96) -> tuple:
    """Per-patch features of one image: (H, W), (H, W, 3) or (1, H, W, 3)
    in [0, 1] -> ((P, 36) features, (P,) 0/1 sharpness mask)."""
    from enhax_torch.ops.resize import resize
    gray = _to_gray(image)
    h = (gray.shape[0] // patch) * patch
    w = (gray.shape[1] // patch) * patch
    if h < patch or w < patch:
        raise ValueError(f"image too small for NIQE patch size {patch}: {tuple(gray.shape)}")
    gray = gray[:h, :w]
    mscn1, sigma = _mscn(gray)
    f1 = _scale_features(mscn1, patch)
    half = resize(gray[..., None], (h // 2, w // 2), method="linear", antialias=True)[..., 0]
    mscn2, _ = _mscn(half)
    f2 = _scale_features(mscn2, patch // 2)
    sharp = _patchify(sigma, patch).mean(dim=(-2, -1))
    weights = (sharp > 0.75 * sharp.max()).float()
    return torch.cat([f1, f2], dim=-1), weights


def _weighted_moments(feats: torch.Tensor, weights: torch.Tensor) -> tuple:
    n = weights.sum().clamp_min(1.0)
    mu = (feats * weights[:, None]).sum(dim=0) / n
    d = (feats - mu) * weights[:, None]
    cov = d.T @ d / (n - 1.0).clamp_min(1.0)
    return mu, cov, n


def fit_niqe_params(images) -> dict:
    """The pristine MVG of a local set of high-quality images:
    {"mu": (36,), "cov": (36, 36), "impl": "self"} (numpy float32), for
    ``niqe``'s self pipeline. The features run on each image's device, the
    moments on the CPU."""
    all_f, all_w = [], []
    for img in images:
        f, m = niqe_features(img)
        all_f.append(f.cpu())
        all_w.append(m.cpu())
    mu, cov, _ = _weighted_moments(torch.cat(all_f), torch.cat(all_w))
    return {"mu": mu.numpy(), "cov": cov.numpy(), "impl": "self"}


def load_niqe_params(path) -> dict:
    """Pristine parameters from a local ``.npz`` or ``.mat``: the MATLAB
    release (``pop_mu``/``pop_cov`` or ``mu_prisparam``/
    ``cov_prisparam``), BasicSR's ``niqe_pris_params.npz``
    (``mu_pris_param``/``cov_pris_param`` + ``gaussian_window``), both
    tagged ``impl="official"``, or a fitted ``.npz`` (``mu``/``cov``,
    ``impl`` if saved, else ``"self"``)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "mu_pris_param" in z:
                return {"mu": np.asarray(z["mu_pris_param"]).reshape(-1),
                        "cov": np.asarray(z["cov_pris_param"]),
                        "gaussian_window": np.asarray(z["gaussian_window"]),
                        "impl": "official"}
            return {"mu": z["mu"], "cov": z["cov"],
                    "impl": str(z["impl"]) if "impl" in z else "self"}
    import scipy.io
    mat = scipy.io.loadmat(path)
    for mu_key, cov_key in (("pop_mu", "pop_cov"), ("mu_prisparam", "cov_prisparam"),
                            ("mu_pris_param", "cov_pris_param")):
        if mu_key in mat:
            out = {"mu": np.asarray(mat[mu_key]).reshape(-1),
                   "cov": np.asarray(mat[cov_key]), "impl": "official"}
            if "gaussian_window" in mat:
                out["gaussian_window"] = np.asarray(mat["gaussian_window"])
            return out
    raise KeyError(f"no NIQE params found in {path}; keys: {list(mat)}")


# -- the official scoring pipeline (BasicSR / pyiqa / MATLAB) -----------------

def _fspecial_gaussian_np(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    """MATLAB's fspecial('gaussian') in float64 (where the params carry no
    window)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    k[k < np.finfo(np.float64).eps * k.max()] = 0.0
    return k / k.sum()


def _aggd_fit_official(x: torch.Tensor, dim) -> tuple:
    """AGGD in the (alpha, beta_l, beta_r) form, beta = std sqrt(G(1/a) /
    G(3/a)). A block with no negative (or no positive) sample gives NaN, as
    the reference's mean over an empty slice does, and alpha the first grid
    value."""
    grid, _, aggd = _tables(x.device)
    neg = (x < 0).to(x.dtype)
    pos = (x > 0).to(x.dtype)
    left_sq = (x * x * neg).sum(dim=dim) / neg.sum(dim=dim)
    right_sq = (x * x * pos).sum(dim=dim) / pos.sum(dim=dim)
    l_std = torch.sqrt(left_sq)
    r_std = torch.sqrt(right_sq)
    gammahat = l_std / r_std
    rhat = x.abs().mean(dim=dim) ** 2 / (x * x).mean(dim=dim)
    rhatnorm = rhat * (gammahat ** 3 + 1) * (gammahat + 1) / ((gammahat ** 2 + 1) ** 2)
    idx = torch.argmin((aggd - rhatnorm[..., None]) ** 2, dim=-1)
    idx = torch.where(torch.isnan(rhatnorm), 0, idx)
    alpha = grid[idx]
    const = torch.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    return alpha, l_std * const, r_std * const


def _official_scale_feats(mscn: torch.Tensor, patch: int) -> torch.Tensor:
    """18 features a block at one scale, in the reference's order: the raw
    block's [alpha, (beta_l + beta_r) / 2], then for each pair product
    (wrapping within the block) [alpha, mean, beta_l, beta_r]."""
    blocks = _patchify(mscn, patch)
    a, bl, br = _aggd_fit_official(blocks, dim=(-2, -1))
    feats = [a, (bl + br) / 2.0]
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        pair = blocks * torch.roll(blocks, shifts=(dy, dx), dims=(-2, -1))
        a, bl, br = _aggd_fit_official(pair, dim=(-2, -1))
        mean = (br - bl) * (_gamma(2.0 / a) / _gamma(1.0 / a))
        feats.extend([a, mean, bl, br])
    return torch.stack(feats, dim=-1)


def _mscn_official(gray: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Replicate-padded MSCN; sigma takes abs() rather than a clamp. The
    window moments are float64: on a Y channel in [16, 235] the local
    variance is E[x^2] - mu^2 with both terms ~4e4, which float32 leaves
    ~3e-3 off."""
    p = win.shape[0] // 2
    g = gray.double()
    x = F.pad(g[None, None], (p,) * 4, mode="replicate")[0, 0]
    mu = _conv_valid(x, win.double())
    sigma = torch.sqrt((_conv_valid(x * x, win.double()) - mu * mu).abs())
    return ((g - mu) / (sigma + 1.0)).float()


def _to_y_channel(image: torch.Tensor) -> torch.Tensor:
    """BT.601 studio-swing Y in [16, 235] from RGB in [0, 1]."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return 65.481 * r + 128.553 * g + 24.966 * b + 16.0


def niqe_official(image, params: dict, crop_border: int = 0, convert_to: str = "y",
                  block: int = 96) -> float:
    """The official NIQE score (BasicSR's ``calculate_niqe``) of an RGB image
    in [0, 1]: the features in float32 on the image's device, the MVG
    statistics and the pseudo-inverse in float64 on the host."""
    image = _image(image)
    if image.ndim == 3:
        if convert_to == "y":
            gray = _to_y_channel(image)
        elif convert_to == "gray":
            gray = (0.299 * image[..., 0] + 0.587 * image[..., 1]
                    + 0.114 * image[..., 2]) * 255.0
        else:
            raise ValueError(f"convert_to must be 'y' or 'gray': {convert_to}")
    else:
        gray = image * 255.0
    if crop_border:
        gray = gray[crop_border:-crop_border, crop_border:-crop_border]
    h = (gray.shape[0] // block) * block
    w = (gray.shape[1] // block) * block
    if h < block or w < block:
        raise ValueError(f"image too small for NIQE block size {block}: {tuple(gray.shape)}")
    gray = gray[:h, :w]
    win = torch.as_tensor(np.asarray(params.get("gaussian_window", _fspecial_gaussian_np())),
                          dtype=torch.float32, device=gray.device)
    f1 = _official_scale_feats(_mscn_official(gray, win), block)
    # the reference halves with cv2's INTER_LINEAR at 0.5: the 2x2 mean
    half = (gray[0::2, 0::2] + gray[0::2, 1::2] + gray[1::2, 0::2] + gray[1::2, 1::2]) / 4.0
    f2 = _official_scale_feats(_mscn_official(half, win), block // 2)
    feats = torch.cat([f1, f2], dim=-1).cpu().numpy().astype(np.float64)
    mu_d = np.nanmean(feats, axis=0)
    good = feats[~np.isnan(feats).any(axis=1)]
    cov_d = np.cov(good, rowvar=False)
    mu_p = np.asarray(params["mu"], np.float64).reshape(-1)
    cov_p = np.asarray(params["cov"], np.float64)
    d = mu_p - mu_d
    inv = np.linalg.pinv((cov_p + cov_d) / 2.0)
    return float(np.sqrt(max(d @ inv @ d, 0.0)))


# the JAX package's pinv cut-off: 10 x max(m, n) x eps(float32) x sigma_max
_PINV_RTOL = 10 * 36 * float(np.finfo(np.float32).eps)


def niqe(image, params: dict) -> torch.Tensor:
    """The NIQE score (lower is better) of one image against pristine
    params: official-layout params (``impl="official"`` or a
    ``gaussian_window``) through ``niqe_official``, fitted ones through the
    self pipeline (the MVG in float32 on the image's device)."""
    if params.get("impl") == "official" or "gaussian_window" in params:
        return torch.tensor(niqe_official(image, params), dtype=torch.float32)
    feats, weights = niqe_features(image)
    mu_d, cov_d, _ = _weighted_moments(feats, weights)
    mu_p = torch.as_tensor(np.asarray(params["mu"]), dtype=torch.float32, device=feats.device)
    cov_p = torch.as_tensor(np.asarray(params["cov"]), dtype=torch.float32, device=feats.device)
    d = mu_p - mu_d
    pinv = torch.linalg.pinv((cov_p + cov_d) / 2.0, rtol=_PINV_RTOL)
    return torch.sqrt((d @ pinv @ d).clamp_min(0.0))


def make_niqe(params: dict):
    """Bind pristine params -> ``fn(pred, target=None)``."""
    def metric(pred, target=None):
        return niqe(pred, params)
    return metric


@METRICS.register(name="niqe")
def _niqe_metric(pred, target=None, params: dict | None = None):
    """The registry's NIQE: ``params=``, or the ``.mat``/``.npz`` that
    ``ENHAX_NIQE_PARAMS`` names."""
    if params is None:
        path = os.environ.get("ENHAX_NIQE_PARAMS")
        if not path:
            raise ValueError(
                "NIQE needs pristine MVG parameters: pass params=, or set "
                "ENHAX_NIQE_PARAMS to niqe_modelparameters.mat (official) or "
                "an .npz from enhax_torch.nn.niqe.fit_niqe_params")
        params = load_niqe_params(path)
    return niqe(pred, params)
