"""Colour conversions on (..., H, W, C) RGB images.

Port of ``rgb_to_grayscale``, ``rgb_to_hsv``, ``hsv_to_rgb``,
``rgb_to_hvi`` and ``hvi_to_rgb`` from ``enhax/ops/color.py`` (kornia's
conventions: hue in [0, 2 pi], saturation and value in [0, 1]; HVI as
HVI-CIDNet's). Differentiable; the branches are ``torch.where``.
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


def rgb_to_hvi(image: torch.Tensor, density_k=0.2, eps: float = 1e-8) -> torch.Tensor:
    """RGB -> HVI: the hue's (cos, sin) scaled by saturation and by the
    colour sensitivity (sin(v pi/2) + eps)^k, then the value. ``density_k``
    may be a learned scalar tensor. The hue's branches in the order r, g,
    b (the reference's masked writes, the last of which wins)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    value = torch.maximum(torch.maximum(r, g), b)
    img_min = torch.minimum(torch.minimum(r, g), b)
    dd = value - img_min + eps
    hue = torch.where(r == value, torch.remainder((g - b) / dd, 6.0),
                      torch.where(g == value, 2.0 + (b - r) / dd, 4.0 + (r - g) / dd))
    hue = torch.where(img_min == value, torch.zeros_like(hue), hue) / 6.0
    saturation = torch.where(value == 0, torch.zeros_like(value),
                             (value - img_min) / (value + eps))
    sensitive = torch.pow(torch.sin(value * 0.5 * math.pi) + eps, density_k)
    x = sensitive * saturation * torch.cos(2.0 * math.pi * hue)
    y = sensitive * saturation * torch.sin(2.0 * math.pi * hue)
    return torch.stack([x, y, value], dim=-1)


def hvi_to_rgb(image: torch.Tensor, density_k=0.2, eps: float = 1e-8) -> torch.Tensor:
    """HVI -> RGB, the inverse of ``rgb_to_hvi`` (through HSV)."""
    h = image[..., 0].clamp(-1, 1)
    v = image[..., 1].clamp(-1, 1)
    val = image[..., 2].clamp(0, 1)
    sensitive = torch.pow(torch.sin(val * 0.5 * math.pi) + eps, density_k)
    h = (h / (sensitive + eps)).clamp(-1, 1)
    v = (v / (sensitive + eps)).clamp(-1, 1)
    hue = torch.remainder(torch.atan2(v, h) / (2 * math.pi), 1.0)
    sat = torch.sqrt(h * h + v * v).clamp(0, 1)
    return hsv_to_rgb(torch.stack([hue * 2.0 * math.pi, sat, val.clamp(0, 1)], dim=-1))
