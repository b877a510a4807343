"""Modulated deformable convolution (DCNv2).

Port of ``enhax/nn/deform.py`` (AirNet's ``DCN_layer``, the reference's
``mmcv.ops.modulated_deform_conv2d``): for every output pixel p and kernel
tap k the input is sampled at p + p_k + Δp_k by bilinear interpolation,
each of the four corners zeroed on its own where it lies outside the map,
scaled by the tap's modulation mask and reduced with the conv weight.
Stride 1, padding (kh // 2, kw // 2), one group.

Layout: NHWC. ``offset`` is read interleaved, [Δy_0, Δx_0, Δy_1, Δx_1, ...]
over the taps in row-major (ky, kx) order; ``mask`` has one channel a tap
(already through its sigmoid); ``weight`` is torch's (Cout, C, kh, kw).

Plain PyTorch, as the JAX package computes it (XLA gathers, outside any
Pallas kernel). Each corner is one gather of all taps at once from the
flattened (B*H*W, C) map (``index_select`` with an index of B*H*W*K rows,
no (B, H*W, C) index tensor; its backward is an ``index_add_``, where
advanced indexing's, a sorted ``index_put_``, took 88% of an AirNet train
step on an H100), and the taps are contracted with the weight in one
(B*H*W, K*C) x (K*C, Cout) product. Not ``F.grid_sample``: its
normalisation of the coordinate to [-1, 1] and back moves the sample by
about eps * W pixels. The coordinates and the bilinear weights are taken in
float32 at least: the JAX package takes them in the input's dtype, and bf16
holds integers exactly only up to 256, so its bf16 rows and columns round
on larger maps.
"""

from __future__ import annotations

import torch


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """DCNv2 forward of ``x`` (B, H, W, C) with ``offset`` (B, H, W, 2K),
    ``mask`` (B, H, W, K) and ``weight`` (Cout, C, kh, kw), K = kh * kw;
    ``bias`` (Cout,) optional. Returns (B, H, W, Cout)."""
    b, h, w, c = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    cdt = torch.promote_types(x.dtype, torch.float32)
    dev = x.device
    taps = torch.arange(k, device=dev)
    ky = (taps // kw - kh // 2).to(cdt)
    kx = (taps % kw - kw // 2).to(cdt)
    ys = torch.arange(h, device=dev, dtype=cdt)[:, None, None]
    xs = torch.arange(w, device=dev, dtype=cdt)[None, :, None]
    off = offset.to(cdt).reshape(b, h, w, k, 2)
    py = (ys + ky) + off[..., 0]      # (B, H, W, K)
    px = (xs + kx) + off[..., 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0).to(x.dtype)[..., None]
    wx = (px - x0).to(x.dtype)[..., None]
    y0i, x0i = y0.long(), x0.long()
    flat = x.reshape(b * h * w, c)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        g = flat.index_select(0, idx.reshape(-1)).reshape(b, h, w, k, c)
        return torch.where(valid, g, 0.0)

    samp = ((1 - wy) * (1 - wx) * corner(y0i, x0i)
            + (1 - wy) * wx * corner(y0i, x0i + 1)
            + wy * (1 - wx) * corner(y0i + 1, x0i)
            + wy * wx * corner(y0i + 1, x0i + 1))
    samp = samp * mask[..., None]
    # taps major, channels minor: the rows of the (K*C, Cout) weight
    wmat = weight.permute(2, 3, 1, 0).reshape(k * c, cout)
    out = (samp.reshape(b * h * w, k * c) @ wmat).reshape(b, h, w, cout)
    if bias is not None:
        out = out + bias
    return out
