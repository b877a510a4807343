"""Inference engine of the port."""

from enhax_torch.infer.engine import Predictor
from enhax_torch.infer.tiling import tiled_apply, tiled_apply_batched, tiled_apply_frames

__all__ = ["Predictor", "tiled_apply", "tiled_apply_batched", "tiled_apply_frames"]
