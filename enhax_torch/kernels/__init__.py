"""Hand-written CUDA kernels of the hot inference paths, for Hopper (sm_90a).

Port of ``enhax/kernels/__init__.py``. The JAX package gates its Pallas
kernels on the platform and an environment switch; here dispatch is by
device: each wrapper sends a CUDA tensor to its kernel and a CPU tensor to
the plain PyTorch version beside it.

  * ``fused_curve_apply``: the Zero-DCE curve loop with y held in registers.
  * ``fused_curve_upsample_apply``: the Zero-DCE++ path at a reduced curve
    resolution; the curve is interpolated inside the kernel.
  * ``nafblock.k1_apply`` and ``nafblock.k2_apply``: the two halves of the
    fused NAFBlock (NAFNet, NAFNet-TLC), with ``box.box_mean_fast`` (the
    TLC local mean, PyTorch ops) between them.
"""

from enhax_torch.kernels.dce_curve import (apply_curves, fused_curve_apply,
                                           fused_curve_upsample_apply)

__all__ = ["apply_curves", "fused_curve_apply", "fused_curve_upsample_apply"]
