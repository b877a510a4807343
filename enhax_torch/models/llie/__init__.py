"""Low-light image enhancement models."""

from enhax_torch.models.llie import (classical, colie, gcenet, hvi_cidnet, lllinet,  # noqa: F401
                                     llunetpp, lyt_net, pairlie, psenet, rrdnet, rsfnet, ruas,
                                     sci, sgz, zero_dce, zero_didce, zero_ig, zero_mie)
