"""Denoising models."""

from enhax_torch.models.denoise import zsn2n  # noqa: F401
