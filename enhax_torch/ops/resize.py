"""Resize with divisible-by and side modes.

Port of ``enhax/ops/resize.py``. ``jax.image.resize(..., antialias=False)``
samples half-pixel aligned, which is ``F.interpolate(align_corners=False,
antialias=False)`` for bilinear and ``mode="nearest-exact"`` for nearest.
``resize_nearest_torch``, ``resize_bicubic_torch`` and
``resize_align_corners``, which the JAX package writes out by hand to match
torch, are torch's own ``F.interpolate`` modes. A bilinear downscale with
``antialias=True`` is ``jax.image.resize``'s: a triangle filter widened by
the ratio, each output's weights normalised (``linear_weights``), which
torch's own antialiased bilinear is not at small sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from enhax_torch.ops.layout import make_divisible

_MODES = {
    "nearest": "nearest-exact",
    "bilinear": "bilinear",
    "linear": "bilinear",
}


def _target_hw(h: int, w: int, size, side: str, divisible_by) -> tuple[int, int]:
    if isinstance(size, int):
        if side == "short":
            if h < w:
                nh, nw = size, int(round(w * size / h))
            else:
                nh, nw = int(round(h * size / w)), size
        elif side == "long":
            if h > w:
                nh, nw = size, int(round(w * size / h))
            else:
                nh, nw = int(round(h * size / w)), size
        else:  # both
            nh = nw = size
    else:
        nh, nw = int(size[0]), int(size[1])
    if divisible_by:
        nh = make_divisible(nh, divisible_by)
        nw = make_divisible(nw, divisible_by)
    return nh, nw


def _interpolate(x: torch.Tensor, size: tuple[int, int], mode: str,
                 align_corners: bool = False) -> torch.Tensor:
    """F.interpolate over the H/W axes of an (..., H, W, C) tensor."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    kw = {"align_corners": align_corners} if mode in ("bilinear", "bicubic") else {}
    y = F.interpolate(x4, size=size, mode=mode, **kw)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def linear_weights(n_in: int, n_out: int, antialias: bool, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize``'s linear resize along
    one axis: output i samples at (i + 0.5) n_in / n_out - 0.5 with the
    triangle 1 - |d|, its width scaled by n_in / n_out when downscaling
    with ``antialias``, the weights of each output summing to 1."""
    inv = n_in / n_out
    width = max(inv, 1.0) if antialias else 1.0
    f64 = torch.float64
    sample = (torch.arange(n_out, dtype=f64) + 0.5) * inv - 0.5
    w = (1.0 - (sample[:, None] - torch.arange(n_in, dtype=f64)[None, :]).abs() / width).clamp_min(0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return w.to(device=device, dtype=dtype)


def _resize_linear(x: torch.Tensor, size: tuple[int, int], antialias: bool) -> torch.Tensor:
    """``jax.image.resize(..., "linear", antialias)`` over the H/W axes of
    (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    wh = linear_weights(h, size[0], antialias, x.dtype, x.device)
    ww = linear_weights(w, size[1], antialias, x.dtype, x.device)
    return torch.einsum("Hh,...hwc,Ww->...HWc", wh, x, ww)


def resize(
    image: torch.Tensor,
    size=None,
    scale_factor: float | None = None,
    method: str = "bilinear",
    side: str = "both",
    divisible_by: int | None = None,
    antialias: bool = False,
) -> torch.Tensor:
    """Resize an (..., H, W, C) image.

    One of ``size`` (int or (h, w)) or ``scale_factor``; ``side`` in
    {both, short, long}; ``divisible_by`` snaps the target up to a stride
    multiple. ``method`` is bilinear or nearest; ``antialias`` low-passes
    a bilinear downscale as ``jax.image.resize`` does (nearest ignores it).
    """
    if method not in _MODES:
        raise ValueError(f"resize: unsupported method {method!r}; "
                         f"expected one of {sorted(_MODES)}")
    h, w = image.shape[-3], image.shape[-2]
    if size is None and scale_factor is None:
        if divisible_by is None:
            return image
        size = (h, w)
    if size is None:
        size = (int(round(h * scale_factor)), int(round(w * scale_factor)))
    nh, nw = _target_hw(h, w, size, side, divisible_by)
    if (nh, nw) == (h, w):
        return image
    if antialias and method != "nearest" and (nh < h or nw < w):
        return _resize_linear(image, (nh, nw), True)
    return _interpolate(image, (nh, nw), _MODES[method])


def resize_nearest_torch(image: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize with ``F.interpolate``'s default mode:
    src index = floor(dst * in/out) per axis."""
    return _interpolate(image, (int(size[0]), int(size[1])), "nearest")


def resize_bicubic_torch(image: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bicubic resize of (..., H, W, C) with torch's ``F.interpolate(mode=
    "bicubic")``: cubic convolution (a = -0.75), the indices clamped at the
    borders."""
    return _interpolate(image, (int(size[0]), int(size[1])), "bicubic", align_corners)


def resize_align_corners(image: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` (the reference's
    ``nn.UpsamplingBilinear2d``)."""
    size = (int(size[0]), int(size[1]))
    if size == (image.shape[-3], image.shape[-2]):
        return image
    return _interpolate(image, size, "bilinear", align_corners=True)
