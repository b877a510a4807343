"""Model families of the port. Importing this package registers them."""

from enhax_torch.models import dehaze, denoise, llie, multitask, retouch  # noqa: F401
from enhax_torch.models.base import Model, build_model

__all__ = ["Model", "build_model"]
