"""Restoration models for several tasks (denoise, deblur, derain, dehaze, low light,
underwater)."""

from enhax_torch.models.multitask import (hinet, nafnet, restormer, uformer,  # noqa: F401
                                         zero_restore)
