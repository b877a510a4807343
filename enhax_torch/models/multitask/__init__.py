"""Restoration models for several tasks (denoise, deblur)."""

from enhax_torch.models.multitask import nafnet  # noqa: F401
