"""Low-light image enhancement models."""

from enhax_torch.models.llie import zero_dce  # noqa: F401
