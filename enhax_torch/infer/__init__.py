"""Inference engine of the port."""

from enhax_torch.infer.engine import Predictor

__all__ = ["Predictor"]
