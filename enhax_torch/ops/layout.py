"""Image layout utilities (NHWC canonical).

Port of ``enhax/ops/layout.py``. Public tensors stay channels-last, as in
the JAX package; padding goes through an NCHW view because ``F.pad`` pads
the last dimensions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# jnp.pad mode names -> F.pad mode names
_PAD_MODES = {"reflect": "reflect", "edge": "replicate", "constant": "constant"}


def make_divisible(x: int, divisor: int) -> int:
    """Round up to the nearest multiple of ``divisor``."""
    return int(np.ceil(x / divisor) * divisor)


def pad_hw(image: torch.Tensor, ph: int, pw: int, mode: str = "reflect") -> torch.Tensor:
    """Pad (..., H, W, C) by ``ph`` rows at the bottom and ``pw`` columns at
    the right. ``mode`` takes the ``jnp.pad`` names: reflect, edge, constant."""
    if ph == 0 and pw == 0:
        return image
    lead = image.shape[:-3]
    h, w, c = image.shape[-3:]
    x = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.pad(x, (0, pw, 0, ph), mode=_PAD_MODES[mode])
    return x.permute(0, 2, 3, 1).reshape(*lead, h + ph, w + pw, c)


def pad_to_divisible(image: torch.Tensor, divisor: int, mode: str = "reflect"):
    """Pad H/W (at bottom/right) so both are multiples of ``divisor``.

    Returns (padded, (orig_h, orig_w)).
    """
    h, w = image.shape[-3], image.shape[-2]
    ph = make_divisible(h, divisor) - h
    pw = make_divisible(w, divisor) - w
    return pad_hw(image, ph, pw, mode), (h, w)


def unpad(image: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Crop back to (h, w) after ``pad_to_divisible``."""
    h, w = size
    return image[..., :h, :w, :]


def to_4d(image) -> torch.Tensor:
    """Ensure NHWC rank 4: HW -> 1HW1, HWC -> 1HWC."""
    x = torch.as_tensor(image)
    if x.ndim == 2:
        x = x[None, :, :, None]
    elif x.ndim == 3:
        x = x[None]
    elif x.ndim != 4:
        raise ValueError(f"cannot coerce ndim={x.ndim} to 4d NHWC")
    return x
