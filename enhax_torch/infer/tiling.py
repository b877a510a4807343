"""Overlap-tiled full-resolution inference.

Port of ``enhax/infer/tiling.py`` (Restormer's tiled test path: slide a tile
window, accumulate weighted patches, divide by the weights), with the same
tile grid, blend windows and chunking. The JAX package maps the model over
chunk groups with ``lax.map``; here a loop over chunks runs the model on one
chunk at a time, so only one chunk's activations are live. The blend runs
in the input's dtype (the caller's float32: ``Predictor`` casts to bfloat16
inside the model call, as the JAX engine does).
"""

from __future__ import annotations

import numpy as np
import torch


def _tile_starts(full: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, full) with the last tile flush to the end."""
    if full <= tile:
        return [0]
    starts = list(range(0, full - tile + 1, stride))
    if starts[-1] != full - tile:
        starts.append(full - tile)
    return starts


def _hann_window(tile_h: int, tile_w: int) -> torch.Tensor:
    """2D raised-cosine blend weights (avoids seams; min weight epsilon)."""
    wy = np.hanning(tile_h + 2)[1:-1]
    wx = np.hanning(tile_w + 2)[1:-1]
    w = np.outer(wy, wx).astype(np.float32) + 1e-3
    return torch.from_numpy(w)[None, :, :, None]


def _blend_window(tile_h: int, tile_w: int, blend: str) -> torch.Tensor:
    """``'hann'``: raised cosine (seam-free, the default). ``'uniform'``:
    ones, Restormer's unweighted accumulate / count divide exactly."""
    if blend == "uniform":
        return torch.ones(1, tile_h, tile_w, 1)
    if blend == "hann":
        return _hann_window(tile_h, tile_w)
    raise ValueError(f"unknown blend mode: {blend!r}")


def _grid(h: int, w: int, tile, overlap: int):
    th, tw = min(tile[0], h), min(tile[1], w)
    ys = _tile_starts(h, th, max(th - overlap, 1))
    xs = _tile_starts(w, tw, max(tw - overlap, 1))
    return th, tw, [(y, x) for y in ys for x in xs]


def _blend(canvas: torch.Tensor, preds, coords, th: int, tw: int, blend: str) -> torch.Tensor:
    """Accumulate ``preds[k]`` (N, th, tw, C) weighted by the window at
    ``coords[k]`` into a canvas shaped like ``canvas``, divide by the weights."""
    n, h, w, _ = canvas.shape
    win = _blend_window(th, tw, blend).to(canvas.device, canvas.dtype)
    out = torch.zeros_like(canvas)
    acc = torch.zeros(1, h, w, 1, dtype=canvas.dtype, device=canvas.device)
    for pred, (y, x) in zip(preds, coords):
        out[:, y:y + th, x:x + tw] += pred * win
        acc[:, y:y + th, x:x + tw] += win
    return out / acc.clamp_min(1e-8)


def tiled_apply(fn, image: torch.Tensor, tile=(256, 256), overlap: int = 32,
                blend: str = "hann") -> torch.Tensor:
    """Apply ``fn`` (NHWC -> NHWC, shape-preserving) over overlapping tiles,
    one call a tile, and blend."""
    _, h, w, _ = image.shape
    th, tw, coords = _grid(h, w, tile, overlap)
    preds = (fn(image[:, y:y + th, x:x + tw]) for y, x in coords)
    return _blend(image, preds, coords, th, tw, blend)


def _best_chunk(total: int, chunk: int) -> int:
    """The dispatch chunk in [~2/3 * chunk, chunk] with the fewest padded
    tail tiles; the larger chunk wins ties, and the requested chunk (the
    memory bound) is never exceeded."""
    best, best_pad = chunk, (-total) % chunk
    for c in range(chunk - 1, max(1, (2 * chunk + 2) // 3) - 1, -1):
        p = (-total) % c
        if p < best_pad:
            best, best_pad = c, p
            if p == 0:
                break
    return best


def _chunked(fn, patches: torch.Tensor, chunk: int) -> torch.Tensor:
    """``fn`` over ``patches`` (T, th, tw, C) in chunks of ``_best_chunk``
    tiles, the tail padded with copies of the last tile."""
    total = patches.shape[0]
    chunk = _best_chunk(total, max(chunk, 1))
    pad = -total % chunk
    if pad:
        patches = torch.cat([patches, patches[-1:].expand(pad, *patches.shape[1:])])
    preds = [fn(patches[i:i + chunk]) for i in range(0, patches.shape[0], chunk)]
    return torch.cat(preds)[:total]


def tiled_apply_frames(fn, frames: torch.Tensor, tile=(256, 256), overlap: int = 32,
                       chunk: int = 8, blend: str = "hann") -> torch.Tensor:
    """Overlap-tiled apply of ``fn`` ((B, th, tw, C) -> (B, th, tw, C)) to
    all frames (N, H, W, C) at once: every frame's tiles, frame-major, go
    through one chunked stream, which fills the tail chunk across frames.
    Same blend as :func:`tiled_apply`."""
    n, h, w, _ = frames.shape
    th, tw, coords = _grid(h, w, tile, overlap)
    patches = torch.stack([frames[f, y:y + th, x:x + tw] for f in range(n) for y, x in coords])
    preds = _chunked(fn, patches, chunk).reshape(n, len(coords), *patches.shape[1:3], -1)
    return _blend(frames, preds.unbind(1), coords, th, tw, blend)


def tiled_apply_batched(fn, image: torch.Tensor, tile=(256, 256), overlap: int = 32,
                        chunk: int = 8, blend: str = "hann") -> torch.Tensor:
    """:func:`tiled_apply` with one image's tiles batched through ``fn`` in
    chunks of ``chunk``."""
    if image.shape[0] != 1:
        raise ValueError("batched tiling operates on a single image")
    return tiled_apply_frames(fn, image, tile, overlap, chunk, blend)
