"""Prediction engine.

Port of ``enhax/infer/engine.py``: reflect pad to the model's stride
multiple (or up to a shape bucket), batched forward, crop back.

  * **pad, don't resize**: content-preserving reflect pad, cropped after.
  * **shape buckets**: padded H/W round up to the nearest bucket.
  * **batched**: ``predict_iter`` groups consecutive same-shaped items.
  * **tiled**: with ``tile=(th, tw, overlap)`` every frame's overlapping
    tiles go through the model in chunks (``infer/tiling.py``), blended in
    float32.

Inputs are NHWC (or HWC) arrays or tensors in [0, 1]; outputs are tensors
on the Predictor's device. The forward runs under ``torch.inference_mode``.
Multi-device and instance-model inference are not ported yet (ROADMAP
items 1.14 and 1.13).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from enhax_torch.infer.tiling import tiled_apply_frames
from enhax_torch.models.base import Model, resolve_device
from enhax_torch.ops.layout import make_divisible, pad_hw
from enhax_torch.ops.resize import resize as resize_op


def _pad_hw(v: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Trailing reflect pad of (ph, pw) on the H/W axes of ...HWC.

    Reflect requires pad < dim: for targets far larger than the image
    (small image into a big bucket), reflect what fits and edge-extend the
    rest; the pad region is cropped away after inference.
    """
    h, w = v.shape[-3], v.shape[-2]
    rh, rw = min(ph, h - 1), min(pw, w - 1)
    v = pad_hw(v, rh, rw, "reflect")
    if ph > rh or pw > rw:
        v = pad_hw(v, ph - rh, pw - rw, "edge")
    return v


def _pad_images(images: dict, th: int, tw: int) -> tuple[dict, tuple[int, int]]:
    """Pad every image-like entry shaped like ``image`` to (th, tw)."""
    any_img = images["image"]
    h, w = any_img.shape[-3], any_img.shape[-2]
    if (th, tw) == (h, w):
        return images, (h, w)
    out = {}
    for k, v in images.items():
        if v.ndim >= 3 and v.shape[-3] == h and v.shape[-2] == w:
            out[k] = _pad_hw(v, th - h, tw - w)
        else:
            out[k] = v
    return out, (h, w)


def _pad_batch(images: dict, divisor: int) -> tuple[dict, tuple[int, int]]:
    """Reflect-pad every image-like entry to H/W multiples of divisor."""
    h, w = images["image"].shape[-3], images["image"].shape[-2]
    return _pad_images(images, make_divisible(h, divisor), make_divisible(w, divisor))


def _pad_to_bucket(images: dict, buckets: tuple) -> tuple[dict, tuple[int, int]]:
    """Reflect-pad H/W up to the nearest bucket size (largest bucket caps)."""
    h, w = images["image"].shape[-3], images["image"].shape[-2]

    def pick(v):
        for b in buckets:
            if v <= b:
                return b
        return v  # larger than all buckets: keep exact

    return _pad_images(images, pick(h), pick(w))


def _crop_outputs(outputs: dict, size: tuple[int, int]) -> dict:
    h, w = size
    out = {}
    for k, v in outputs.items():
        if hasattr(v, "ndim") and v.ndim >= 3 and v.shape[-3] >= h and v.shape[-2] >= w:
            out[k] = v[..., :h, :w, :]
        else:
            out[k] = v
    return out


def _is_array_like(v) -> bool:
    return hasattr(v, "shape") or (isinstance(v, (list, tuple)) and len(v) > 0
                                   and not isinstance(v[0], (str, dict)))


class Predictor:
    """Batched predictor.

    Args:
        model: enhax_torch Model. It is moved to ``device``; with ``bf16``
            the Predictor serves a bfloat16 copy of its module and the
            caller's parameters keep their dtype (as the JAX engine casts a
            copy of the variables).
        image_size: optional fixed (h, w): with ``resize``, inputs are
            resized to it and the output back to the input size.
        bucket_sizes: optional shape buckets; padded H/W round up to them.
        tile: optional (tile_h, tile_w, overlap) for overlap-tiled
            full-resolution inference, in chunks of up to 8 tiles.
        tile_blend: ``'hann'`` (seam-free) or ``'uniform'`` (the reference's
            unweighted accumulate / divide).
        bf16: params + activations in bfloat16; float32 outputs.
        device: where the forward runs. CUDA unless asked otherwise; with no
            card that raises.
    """

    def __init__(self, model: Model, image_size=None, resize: bool = False,
                 tile: tuple | None = None, bucket_sizes: tuple | None = None,
                 mesh=None, spatial: bool = False, bf16: bool = False,
                 tile_blend: str = "hann", device="cuda"):
        if mesh is not None or spatial:
            raise NotImplementedError("multi-device inference is not ported yet "
                                      "(ROADMAP item 1.14)")
        if model.instance_steps > 0:
            raise NotImplementedError(f"{model.name} is an instance model; instance "
                                      "inference is not ported yet (ROADMAP item 1.13)")
        self.device = resolve_device(device)
        self.bf16 = bool(bf16)
        model = model.to(device=self.device)
        if self.bf16:
            model = dataclasses.replace(
                model, module=copy.deepcopy(model.module).to(dtype=torch.bfloat16))
        self.model = model
        self.image_size = image_size
        self.resize = resize
        self.bucket_sizes = tuple(sorted(bucket_sizes)) if bucket_sizes else None
        self.tile = tile
        self.tile_blend = tile_blend

    def _forward(self, datapoint: dict) -> dict:
        if self.bf16:
            datapoint = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
                         for k, v in datapoint.items()}
        out = self.model.apply(datapoint)
        if self.bf16:
            out = {k: (v.float() if v.dtype == torch.bfloat16 else v)
                   for k, v in out.items()}
        return out

    def infer(self, datapoint: dict) -> dict:
        """Single-batch inference with timing (``time``, in seconds)."""
        self.model.assert_datapoint(datapoint)
        # keep arrays and numeric lists; drop meta dicts/strings
        dp = {k: torch.as_tensor(v).to(self.device)
              for k, v in datapoint.items() if _is_array_like(v)}
        for k, v in dp.items():
            if v.dtype == torch.float64:  # as jnp.asarray does without x64
                v = v.float()
            dp[k] = v[None] if v.ndim == 3 else v
        orig_hw = (dp["image"].shape[-3], dp["image"].shape[-2])
        if self.resize and self.image_size is not None:
            dp = {k: resize_op(v, self.image_size) if v.ndim == 4 else v
                  for k, v in dp.items()}
        dp, unpad_hw = _pad_batch(dp, self.model.size_divisor)
        if self.bucket_sizes:
            dp, unpad_hw2 = _pad_to_bucket(dp, self.bucket_sizes)
            unpad_hw = (min(unpad_hw[0], unpad_hw2[0]),
                        min(unpad_hw[1], unpad_hw2[1]))

        with torch.inference_mode():
            t0 = time.perf_counter()
            if self.tile is None:
                outputs = self._forward(dp)
            else:
                outputs = {self.model.out_key: self._tiled(dp)}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0

            s = self.model.scale or 1
            outputs = _crop_outputs(outputs, (unpad_hw[0] * s, unpad_hw[1] * s))
            if self.resize and self.image_size is not None:
                key = self.model.out_key
                outputs[key] = resize_op(outputs[key], orig_hw)
        self.model.assert_outputs(outputs)
        outputs["time"] = dt
        return outputs

    def _tiled(self, dp: dict) -> torch.Tensor:
        """All frames' tiles through one chunked stream, blended in the
        input's dtype (the model's bf16 cast happens inside ``_forward``)."""
        if (self.model.scale or 1) != 1:
            raise ValueError(f"tile= is only supported for shape-preserving models; "
                             f"{self.model.name} has scale={self.model.scale} (tiled_apply "
                             f"accumulates into an input-shaped canvas)")
        key = self.model.out_key
        return tiled_apply_frames(lambda x: self._forward({**dp, "image": x})[key],
                                  dp["image"], tile=self.tile[0:2], overlap=self.tile[2],
                                  blend=self.tile_blend)

    def __call__(self, datapoint: dict) -> dict:
        return self.infer(datapoint)

    def predict_iter(self, source, batch_size: int = 8):
        """Batched prediction over an iterable of datapoint dicts.

        Groups consecutive same-shaped items into batches and yields
        (outputs, metas), where outputs are per batch and metas is the list
        of item metas.
        """
        pending: list[dict] = []
        pending_shape = None

        def flush():
            nonlocal pending, pending_shape
            if not pending:
                return None
            batch = {}
            for k in pending[0]:
                if k == "meta":
                    continue
                vals = [p[k] for p in pending if p.get(k) is not None]
                if vals and hasattr(vals[0], "shape"):
                    batch[k] = torch.stack([torch.as_tensor(v) for v in vals])
            metas = [p.get("meta", {}) for p in pending]
            out = self.infer(batch)
            pending = []
            pending_shape = None
            return out, metas

        for item in source:
            shape = tuple(item["image"].shape)
            if pending and (shape != pending_shape or len(pending) >= batch_size):
                res = flush()
                if res:
                    yield res
            pending.append(item)
            pending_shape = shape
        res = flush()
        if res:
            yield res
