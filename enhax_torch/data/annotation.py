"""Annotations: lazily decoded records of a datapoint's attributes.

Port of the part of ``enhax/data/annotation.py`` that paired image datasets
need: ``ImageAnnotation`` (a path, decoded on demand to HWC float32 RGB in
[0, 1] through ``ops.io.read_image``), ``DepthMapAnnotation``,
``DatapointAttributes`` (the ordered
attribute -> annotation type map) and ``collate_datapoints``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from enhax_torch.constants import IMAGE_EXTS


class ImageAnnotation:
    """A lazily decoded image file."""

    def __init__(self, path):
        self.path = Path(path)
        if self.path.suffix.lower() not in IMAGE_EXTS:
            raise ValueError(f"not an image path: {path}")

    @property
    def name(self) -> str:
        return self.path.name

    @property
    def stem(self) -> str:
        return self.path.stem

    @property
    def data(self) -> np.ndarray:
        """Decode -> HWC float32 RGB in [0, 1] (gray: (H, W, 1))."""
        from enhax_torch.ops.io import read_image
        return read_image(self.path, to_float=True, normalize=True)

    @property
    def meta(self) -> dict:
        return {"name": self.name, "stem": self.stem, "path": str(self.path)}


class DepthMapAnnotation(ImageAnnotation):
    """A depth map image with its source tag; decodes to (H, W, 1)."""

    def __init__(self, path, source: str = "dav2_vitb_g"):
        super().__init__(path)
        self.source = source

    @property
    def data(self) -> np.ndarray:
        from enhax_torch.ops.io import read_image
        img = read_image(self.path, to_float=True, normalize=True)
        if img.shape[-1] == 3:
            img = img.mean(axis=-1, keepdims=True).astype(np.float32)
        return img


class DatapointAttributes(dict):
    """Ordered attribute name -> annotation type."""


def collate_datapoints(datapoints: list[dict]) -> dict:
    """Stack a list of item dicts into one batch dict: equal-shaped HWC
    arrays -> (N, H, W, C), scalars -> arrays, anything else -> a list;
    ``meta`` stays a list."""
    if not datapoints:
        return {}
    batch: dict[str, Any] = {}
    for k in datapoints[0]:
        vals = [dp[k] for dp in datapoints]
        v0 = vals[0]
        if k == "meta":
            batch[k] = vals
        elif isinstance(v0, np.ndarray) and v0.ndim >= 2:
            if all(v is not None and v.shape == v0.shape for v in vals):
                batch[k] = np.stack(vals)
            else:
                batch[k] = vals
        elif isinstance(v0, (int, float, np.integer, np.floating)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = vals
    return batch
