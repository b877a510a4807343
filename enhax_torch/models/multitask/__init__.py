"""Restoration models for several tasks (denoise, deblur, derain, dehaze)."""

from enhax_torch.models.multitask import nafnet, restormer  # noqa: F401
