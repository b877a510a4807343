"""Low-light image enhancement models."""

from enhax_torch.models.llie import colie, gcenet, rrdnet, zero_dce, zero_mie  # noqa: F401
