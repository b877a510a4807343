"""Colour conversions on (..., H, W, C) RGB images.

Port of ``rgb_to_grayscale`` from ``enhax/ops/color.py``; the HSV
conversions come with ROADMAP item 1.5b.
"""

from __future__ import annotations

import torch


def rgb_to_grayscale(image: torch.Tensor, weights=(0.299, 0.587, 0.114)) -> torch.Tensor:
    """ITU-R 601 luma (kornia's default): (..., H, W, 3) -> (..., H, W, 1)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return (weights[0] * r + weights[1] * g + weights[2] * b)[..., None]
