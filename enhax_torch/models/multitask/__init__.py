"""Restoration models for several tasks (denoise, deblur, derain, dehaze)."""

from enhax_torch.models.multitask import hinet, nafnet, restormer, uformer  # noqa: F401
