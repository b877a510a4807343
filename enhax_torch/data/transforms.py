"""Host-side datapoint transforms (numpy).

Port of ``Compose``, ``RandomCrop``, ``RandomFlip`` and
``progressive_patch_schedule`` from ``enhax/data/transforms.py``. A transform maps a datapoint dict to a
datapoint dict and applies the same spatial op to every image-valued
attribute. Each random transform owns a ``np.random.default_rng(seed)``, so
for the same seed and the same order of calls it draws what the JAX
package's draws.
"""

from __future__ import annotations

import numpy as np

_IMAGE_KEYS = ("image", "ref_image", "depth", "mask", "edge", "segmentation")


def _image_keys(dp: dict) -> list[str]:
    return [k for k in dp
            if (k in _IMAGE_KEYS or k.endswith("_image"))
            and isinstance(dp.get(k), np.ndarray) and dp[k].ndim >= 2]


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, dp: dict) -> dict:
        for t in self.transforms:
            dp = t(dp)
        return dp


class RandomCrop:
    """A random window of ``size``, the same for every image attribute."""

    def __init__(self, size: int | tuple = 256, seed: int | None = None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, dp: dict) -> dict:
        keys = _image_keys(dp)
        if not keys:
            return dp
        h, w = dp[keys[0]].shape[:2]
        th, tw = min(self.size[0], h), min(self.size[1], w)
        y = int(self.rng.integers(0, h - th + 1))
        x = int(self.rng.integers(0, w - tw + 1))
        for k in keys:
            dp[k] = dp[k][y : y + th, x : x + tw]
        return dp


class RandomFlip:
    """A horizontal (and, with ``vertical``, a vertical) flip with
    probability ``p``."""

    def __init__(self, p: float = 0.5, vertical: bool = False, seed: int | None = None):
        self.p = p
        self.vertical = vertical
        self.rng = np.random.default_rng(seed)

    def __call__(self, dp: dict) -> dict:
        keys = _image_keys(dp)
        if self.rng.random() < self.p:
            for k in keys:
                dp[k] = dp[k][:, ::-1].copy()
        if self.vertical and self.rng.random() < self.p:
            for k in keys:
                dp[k] = dp[k][::-1].copy()
        return dp


def progressive_patch_schedule(epoch: int, milestones, sizes, batch_sizes) -> tuple:
    """Restormer's progressive training: (crop size, batch size) of the last
    milestone at or before ``epoch``."""
    idx = 0
    for i, m in enumerate(milestones):
        if epoch >= m:
            idx = i
    return sizes[idx], batch_sizes[idx]
