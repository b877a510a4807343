"""Photometric ops on (..., H, W, C) images in [0, 1].

Port of ``scale_gt_mean`` from ``enhax/ops/photometry.py``, the GT-mean
brightness alignment of low-light evaluation.
"""

from __future__ import annotations

import torch

from enhax_torch.ops.color import rgb_to_grayscale


def scale_gt_mean(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``image`` scaled so that its gray mean is ``target``'s, clipped to [0, 1]."""
    mean_image = rgb_to_grayscale(image).mean()
    mean_target = rgb_to_grayscale(target).mean()
    return (image * (mean_target / mean_image.clamp_min(1e-8))).clamp(0.0, 1.0)
