"""Image quality metrics of the port (NHWC, values in [0, data_range]).

Port of ``psnr``, ``psnr_per_image``, ``ssim``, ``ms_ssim``, ``mae``,
``mse`` and ``rmse`` from ``enhax/nn/metrics.py``. SSIM follows
pytorch-msssim as the JAX package does: a Gaussian window (11, 1.5), a
*valid* separable filter (no padding), k1 = 0.01, k2 = 0.03, everything in
float32; MS-SSIM takes the standard five-scale weights.
``SegmentationMetric`` is the metric CLI's ``--task segment``;
``compute_efficiency_score`` the predict CLI's ``--benchmark``. The
extended image metrics are in ``metrics_img``, NIQE and BRISQUE in
``niqe`` and ``brisque``.
"""

from __future__ import annotations

import numpy as np
import torch

from enhax_torch.constants import METRICS

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


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


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 mean over (N, H, W, C), cropped to even H and W."""
    h, w = x.shape[-3] // 2, x.shape[-2] // 2
    x = x[..., : h * 2, : w * 2, :]
    return x.reshape(*x.shape[:-3], h, 2, w, 2, x.shape[-1]).mean(dim=(-4, -2))


@METRICS.register(name="ms_ssim",
                  aliases=["multiscale_ssim", "multiscale_structural_similarity_index_measure"])
def ms_ssim(input, target, data_range: float = 1.0, window_size: int = 11,
            sigma: float = 1.5, weights=None, k: tuple = (0.01, 0.03)) -> torch.Tensor:
    """Multi-scale SSIM: the relu'd mean cs of each scale but the last and
    the relu'd mean SSIM of the last, to the power of their weights. Scales
    the image is too small for (the window after k halvings) are dropped
    and the rest of the weights renormalised."""
    w = list(weights if weights is not None else _MSSSIM_WEIGHTS)
    x, y = input.float(), target.float()
    min_side = min(x.shape[-3], x.shape[-2])
    max_levels = max(1, int(np.floor(np.log2(min_side / window_size))) + 1)
    if len(w) > max_levels:
        w = w[:max_levels]
        w = [wi / sum(w) for wi in w]
    terms = []
    for i in range(len(w)):
        ssim_map, cs = _ssim_components(x, y, data_range, window_size, sigma, k)
        if i < len(w) - 1:
            terms.append(torch.relu(cs.mean()))
            x, y = _avg_pool2(x), _avg_pool2(y)
        else:
            terms.append(torch.relu(ssim_map.mean()))
    w = torch.tensor(w, dtype=torch.float32, device=x.device)
    return torch.prod(torch.stack(terms) ** w)


@METRICS.register(name="mae")
def mae(input, target, **_) -> torch.Tensor:
    return (input - target).abs().mean()


@METRICS.register(name="mse")
def mse(input, target, **_) -> torch.Tensor:
    return ((input - target) ** 2).mean()


@METRICS.register(name="rmse")
def rmse(input, target, **_) -> torch.Tensor:
    return torch.sqrt(((input - target) ** 2).mean())


# -- segmentation (the metric CLI's --task segment) ---------------------------

class SegmentationMetric:
    """A confusion matrix over label maps, accumulated image by image
    (``add_batch``), and its mIoU, mPA, PA and FWIoU, as the JAX package's:
    labels outside [0, num_class) are left out, a class absent from both
    maps is left out of the means (numpy's nanmean). The counts accumulate
    in float64 on ``device`` (``torch.bincount``); the ratios are numpy's
    on the host."""

    def __init__(self, num_class: int, device="cpu"):
        self.num_class = num_class
        self.device = torch.device(device)
        self.reset()

    def add_batch(self, pred, label) -> None:
        pred = torch.as_tensor(pred, device=self.device).reshape(-1).long()
        label = torch.as_tensor(label, device=self.device).reshape(-1).long()
        if pred.shape != label.shape:
            raise ValueError(f"prediction and label sizes differ: {pred.shape} {label.shape}")
        mask = (label >= 0) & (label < self.num_class)
        count = torch.bincount(self.num_class * label[mask] + pred[mask],
                               minlength=self.num_class ** 2)
        self.confusion_matrix += count.reshape(self.num_class, self.num_class).double()

    def _cm(self) -> np.ndarray:
        return self.confusion_matrix.cpu().numpy()

    def pixel_accuracy(self) -> float:
        cm = self._cm()
        return float(np.diag(cm).sum() / cm.sum())

    def mean_pixel_accuracy(self) -> float:
        cm = self._cm()
        with np.errstate(divide="ignore", invalid="ignore"):
            class_acc = np.diag(cm) / cm.sum(axis=0)
        return float(np.nanmean(class_acc))

    def mean_iou(self) -> float:
        cm = self._cm()
        inter = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0) - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / union
        return float(np.nanmean(iou))

    def frequency_weighted_iou(self) -> float:
        cm = self._cm()
        freq = cm.sum(axis=1) / cm.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            iu = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
        return float((freq[freq > 0] * iu[freq > 0]).sum())

    def reset(self) -> None:
        self.confusion_matrix = torch.zeros((self.num_class, self.num_class),
                                            dtype=torch.float64, device=self.device)


# -- efficiency (the predict CLI's --benchmark) ------------------------------

def compute_efficiency_score(fn, datapoint: dict, n_params: int, runs: int = 20,
                             warmup: int = 2) -> tuple:
    """(GFLOPs, params in M, seconds a call) of ``fn(datapoint)``.

    Port of ``enhax/nn/metrics.py::compute_efficiency_score``. The JAX
    package reads its FLOPs from XLA's cost analysis of the compiled
    forward; here ``torch.utils.flop_counter.FlopCounterMode`` counts one
    call's matrix products and convolutions (2 flops a multiply-add;
    elementwise work is not counted, so the two packages' figures differ).
    The seconds are the mean of ``runs`` calls after ``warmup``: CUDA events
    on the card, the host clock on the CPU."""
    import time

    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode():
        counter = FlopCounterMode(display=False)
        with counter:
            fn(datapoint)
        for _ in range(warmup):
            fn(datapoint)
        on_card = any(t.is_cuda for t in datapoint.values() if torch.is_tensor(t))
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(runs):
                fn(datapoint)
            end.record()
            torch.cuda.synchronize()
            seconds = start.elapsed_time(end) / 1e3 / runs
        else:
            t0 = time.perf_counter()
            for _ in range(runs):
                fn(datapoint)
            seconds = (time.perf_counter() - t0) / runs
    return counter.get_total_flops() / 1e9, n_params / 1e6, seconds
