"""Box filter on NHWC images.

Port of ``box_filter_sum``, ``box_window_count`` and ``box_filter`` from
``enhax/ops/filtering.py``: the window sum over (2r+1)^2 pixels, truncated at
the borders, as a difference of cumulative sums along H and then W.
"""

from __future__ import annotations

import torch


def _window_sum_1d(v: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """out[i] = sum of v[j] over |i - j| <= r along ``dim``, border-truncated:
    with c the cumsum, c[min(i+r, n-1)] - (c[i-r-1] if i > r else 0)."""
    n = v.shape[dim]
    r = min(radius, n - 1)
    c = torch.cumsum(v, dim=dim)
    tail = list(c.shape)
    tail[dim] = r
    out = torch.cat([c.narrow(dim, r, n - r), c.narrow(dim, n - 1, 1).expand(tail)], dim=dim)
    if radius + 1 < n:
        out.narrow(dim, radius + 1, n - radius - 1).sub_(c.narrow(dim, 0, n - radius - 1))
    return out


def box_filter_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window, truncated at the borders; (..., H, W, C)."""
    r = int(radius)
    return _window_sum_1d(_window_sum_1d(x, r, x.ndim - 3), r, x.ndim - 2)


def box_window_count(shape_hw: tuple[int, int], radius: int,
                     dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Pixels in each border-truncated window, (H, W, 1)."""
    h, w = shape_hw
    r = int(radius)

    def span(n):
        i = torch.arange(n, device=device)
        return torch.clamp(i + r, max=n - 1) - torch.clamp(i - r, min=0) + 1

    return (span(h)[:, None] * span(w)[None, :]).to(dtype)[..., None]


def box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Window mean with border-truncated windows."""
    n = box_window_count((x.shape[-3], x.shape[-2]), radius, x.dtype, x.device)
    return box_filter_sum(x, radius) / n
