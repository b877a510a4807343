"""Restoration models for several tasks (denoise, deblur, derain, dehaze, low light,
underwater)."""

from enhax_torch.models.multitask import (adair, airnet, hinet, mprnet, nafnet,  # noqa: F401
                                         restormer, uformer, zero_restore)
