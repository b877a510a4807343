"""Dehazing models."""

from enhax_torch.models.dehaze import zid  # noqa: F401
