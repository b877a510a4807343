"""Geometric image ops.

Port of ``pair_downsample`` from ``enhax/ops/geometry.py``: ZSN2N's pair of
half-resolution sub-images.
"""

from __future__ import annotations

import torch


def pair_downsample(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two half-resolution images of (..., H, W, C) by diagonal 2x2 means:
    d1 the anti-diagonal's (top right, bottom left), d2 the main
    diagonal's; an odd last row or column is dropped."""
    h2, w2 = image.shape[-3] // 2, image.shape[-2] // 2
    x = image[..., : h2 * 2, : w2 * 2, :]
    blocks = x.reshape(*x.shape[:-3], h2, 2, w2, 2, x.shape[-1])
    tl, tr = blocks[..., 0, :, 0, :], blocks[..., 0, :, 1, :]
    bl, br = blocks[..., 1, :, 0, :], blocks[..., 1, :, 1, :]
    return 0.5 * (tr + bl), 0.5 * (tl + br)
