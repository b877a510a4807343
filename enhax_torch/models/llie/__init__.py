"""Low-light image enhancement models."""

from enhax_torch.models.llie import (colie, gcenet, hvi_cidnet, lllinet, llunetpp,  # noqa: F401
                                     lyt_net, psenet, rrdnet, zero_dce, zero_ig, zero_mie)
