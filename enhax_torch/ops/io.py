"""Host-side image I/O (numpy in, numpy out; RGB; decode via OpenCV).

Port of ``enhax/ops/io.py``. OpenCV is imported inside the functions, so
the package imports on machines that lack it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_image(path, to_float: bool = True, normalize: bool = True) -> np.ndarray:
    """Read an image file as HWC RGB numpy array.

    ``normalize=True`` -> float32 in [0,1]; else uint8 in [0,255].
    Gray images come back as (H, W, 1).
    """
    import cv2
    path = str(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    if img.ndim == 2:
        img = img[:, :, None]
    elif img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGB)
    elif img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.dtype == np.uint16:
        img = (img.astype(np.float32) / 65535.0 * 255.0).astype(np.uint8)
    if to_float or normalize:
        img = img.astype(np.float32)
        if normalize:
            img = img / 255.0
    return img


def write_image(path, image) -> None:
    """Write an HWC RGB image (float [0,1] or uint8) via OpenCV."""
    import cv2
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    img = np.asarray(image)
    if img.ndim == 4:
        if img.shape[0] != 1:
            raise ValueError("write_image expects a single image")
        img = img[0]
    if img.dtype in (np.float32, np.float64, np.float16):
        img = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        out = img[:, :, 0]
    else:
        out = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(str(path), out):
        raise IOError(f"cannot write image: {path}")
