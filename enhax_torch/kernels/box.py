"""TLC local mean of the fused NAFBlock.

Port of ``box_sum_fast`` and ``box_mean_fast`` from ``enhax/kernels/box.py``.
The JAX package computes the border-truncated window sum as two banded
matmuls, which suit the TPU's matrix unit; it is no Pallas kernel. Here it
is a difference of cumulative sums in float32 (``ops.filtering``): on the
card the banded matmuls would cost 2*W (then 2*H) operations per element,
the running sums a few memory passes. Both accumulate in float32.
"""

from __future__ import annotations

import torch

from enhax_torch.ops.filtering import box_filter_sum, box_window_count


def box_sum_fast(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Border-truncated (2r+1)^2 window sum of (B, H, W, C), in float32."""
    return box_filter_sum(x.float(), radius)


def box_mean_fast(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Border-truncated window mean, accumulated in float32, in x's dtype."""
    n = box_window_count((x.shape[-3], x.shape[-2]), radius, device=x.device)
    return (box_sum_fast(x, radius) / n).to(x.dtype)
