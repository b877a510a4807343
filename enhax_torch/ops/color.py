"""Colour conversions on (..., H, W, C) RGB images.

Port of ``rgb_to_grayscale``, ``rgb_to_hsv`` and ``hsv_to_rgb`` from
``enhax/ops/color.py`` (kornia's conventions: hue in [0, 2 pi], saturation
and value in [0, 1]). Differentiable; the branches are ``torch.where``.
"""

from __future__ import annotations

import math

import torch


def rgb_to_grayscale(image: torch.Tensor, weights=(0.299, 0.587, 0.114)) -> torch.Tensor:
    """ITU-R 601 luma (kornia's default): (..., H, W, 3) -> (..., H, W, 1)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return (weights[0] * r + weights[1] * g + weights[2] * b)[..., None]


def rgb_to_hsv(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) RGB -> HSV. The hue of a grey pixel (max == min) is 0; its
    divisions run on max - min + 1 there, so neither value nor gradient is
    0/0."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    s = deltac / (maxc + eps)
    grey = deltac == 0
    dd = deltac + grey.to(deltac.dtype)
    rc, gc, bc = (maxc - r) / dd, (maxc - g) / dd, (maxc - b) / dd
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(grey, torch.zeros_like(h), h)
    h = 2.0 * math.pi * torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV -> RGB, the inverse of ``rgb_to_hsv``."""
    h, s, v = image[..., 0], image[..., 1], image[..., 2]
    h = h / (2.0 * math.pi)
    h6 = torch.floor(h * 6.0)
    hi = torch.remainder(h6, 6)
    f = h * 6.0 - h6
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    def pick(*vals):
        out = vals[5]
        for i in (4, 3, 2, 1, 0):
            out = torch.where(hi == i, vals[i], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)
