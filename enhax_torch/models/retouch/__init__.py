"""Image retouching models."""

from enhax_torch.models.retouch import neurop  # noqa: F401
