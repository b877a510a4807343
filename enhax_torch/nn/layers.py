"""Layers of the port.

Port of parts of ``enhax/nn/layers.py``:

  * ``DSConv`` and the plain 3x3 ``nn.Conv`` of ``zero_dce_re``. They take
    NCHW tensors.
  * The NAFNet layers: ``LayerNorm2d``, the 1x1 conv ``PWConv``/``conv1x1``,
    ``DWConv3x3``, ``NHWCConv2d`` and ``pixel_shuffle``/``pixel_unshuffle``.
    They take NHWC tensors, as the JAX layers do; a conv runs on the NCHW
    view of the NHWC tensor (channels_last in memory).
  * Restormer's: ``WithBiasLayerNorm`` (``LayerNorm2d`` at eps 1e-5 under
    the reference name ``body``), ``gelu_erf`` and ``PixelUnshuffle``.
  * HINet's ``InstanceNorm2d``, on NCHW tensors.
  * ``flax_conv2d`` (an ``nn.Conv2d`` with flax's default init, drawn from a
    generator and nothing else) and ZID's ``FrozenBatchNorm2d``, on NCHW.
  * Uformer's window attention: ``WindowAttention`` (split q / kv
    projections, the relative position bias, shifted windows through
    ``make_shift_attn_mask``), on NHWC maps.
  * The image priors of GCENet, CoLIE and Zero-MIE: ``median_blur``,
    ``brightness_attention_map`` and ``boundary_aware_prior`` (with the
    magnitude it thresholds, ``boundary_magnitude``), on NHWC tensors.

Flax's SAME padding at a 3x3 kernel and stride 1 is ``padding=1``. Parameter
names and shapes follow the reference torch code (``dw_conv``/``pw_conv``,
``weight``/``bias`` of ``nn.Conv2d``), so released checkpoints load as they
are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(in_channels: int, out_channels: int, bias: bool = True) -> nn.Conv2d:
    """3x3 conv, stride 1, SAME padding."""
    return nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=bias)


class DSConv(nn.Module):
    """Depthwise-separable conv: depthwise kxk, then pointwise 1x1."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.dw_conv = nn.Conv2d(in_channels, in_channels, kernel_size,
                                 padding=kernel_size // 2, groups=in_channels,
                                 bias=bias)
        self.pw_conv = nn.Conv2d(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw_conv(self.dw_conv(x))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's default conv init: truncated normal (+-2 sigma) with variance
    1/fan_in, where fan_in counts one output channel's weights."""
    fan_in = weight[0].numel()
    # the std of a unit normal truncated at +-2
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def flax_conv2d(in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                padding: int | None = None, groups: int = 1, bias: bool = True,
                generator: torch.Generator | None = None, cls=nn.Conv2d) -> nn.Conv2d:
    """``nn.Conv2d`` (or its subclass ``cls``) as flax's ``nn.Conv`` inits
    it: the weight lecun normal from ``generator``, the bias zero; SAME
    padding (k // 2) unless ``padding`` is given. Built by ``skip_init``,
    so torch's global generator is not drawn from."""
    conv = nn.utils.skip_init(cls, in_channels, out_channels, kernel_size,
                              stride=stride,
                              padding=kernel_size // 2 if padding is None else padding,
                              groups=groups, bias=bias)
    lecun_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm that normalises with its running statistics and never
    updates them from the batch (flax's ``use_running_average=True``) on
    NCHW maps: (x - mean) * (rsqrt(var + eps) * weight) + bias. ``mean``
    and ``var`` are parameters, as the JAX package's instance fit steps
    its ``batch_stats`` with the weights; flax's names, its init (1, 0, 0,
    1) and eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + self.eps) * self.weight
        return (x - self.mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


# -- NHWC layers of NAFNet ---------------------------------------------------

class NHWCConv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors (the JAX ``nn.Conv`` layout)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PWConv(nn.Conv2d):
    """1x1 conv on NHWC tensors, as a channel matmul.

    Port of ``enhax/nn/layers.py::PWConv``. The JAX param is a Dense
    ``kernel`` (C_in, C_out); here it is a 1x1 ``Conv2d`` weight
    (C_out, C_in, 1, 1) under the reference name.
    """

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.reshape(self.out_channels, -1), self.bias)


def conv1x1(in_channels: int, out_channels: int, bias: bool = True) -> PWConv:
    """1x1 conv lowered to a channel matmul (see :class:`PWConv`)."""
    return PWConv(in_channels, out_channels, bias=bias)


class DWConv3x3(NHWCConv2d):
    """Depthwise 3x3 SAME conv on NHWC tensors.

    Port of ``enhax/nn/layers.py::DWConv3x3``. The JAX layer picks between
    shifted adds and the grouped conv by channel count, a TPU lowering
    choice; here it is one depthwise conv. Weight (C, 1, 3, 3).
    """

    def __init__(self, channels: int, bias: bool = True):
        super().__init__(channels, channels, 3, padding=1, groups=channels, bias=bias)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NHWC map: biased variance, eps 1e-6.

    Port of ``enhax/nn/layers.py::LayerNorm2d``; its ``scale`` is ``weight``
    here, as in the reference torch code.
    """

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias over the last axis."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,H,W,C*r^2) -> (N,H*r,W*r,C), channels in torch's (C, r, r) order."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/r,W/r,C*r^2), channels in torch's (C, r, r) order."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


class PixelShuffle(nn.Module):
    """``pixel_shuffle`` as a module (no params), for ``nn.Sequential``."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.factor)


class PixelUnshuffle(PixelShuffle):
    """``pixel_unshuffle`` as a module (no params), for ``nn.Sequential``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_unshuffle(x, self.factor)


class WithBiasLayerNorm(nn.Module):
    """Restormer's "WithBias" LayerNorm: ``LayerNorm2d`` with eps 1e-5
    under the reference name ``body`` (``norm1.body.weight``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = LayerNorm2d(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the reference's ``F.gelu``."""
    return F.gelu(x, approximate="none")


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalisation over H and W of an NCHW map:
    biased variance, eps 1e-5, affine ``weight``/``bias``, no running
    statistics (torch's ``InstanceNorm2d(affine=True)``).

    Port of ``enhax/nn/layers.py::InstanceNorm2d`` (its ``scale`` is
    ``weight`` here). The statistics are taken in float32 and cast to the
    input's dtype, as ``jnp.mean`` and ``jnp.var`` take them."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(-2, -1), keepdim=True).to(x.dtype)
        var = xf.var(dim=(-2, -1), keepdim=True, correction=0).to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


# -- image priors -------------------------------------------------------------

def median_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """kornia's median blur of (..., H, W, C): reflect padding, each
    channel's window median (an odd window: the middle value)."""
    p = ksize // 2
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(x4, (p, p, p, p), mode="reflect")
    patches = torch.stack([xp[..., dy:dy + h, dx:dx + w]
                           for dy in range(ksize) for dx in range(ksize)], dim=-1)
    med = patches.median(dim=-1).values
    return med.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def brightness_attention_map(image: torch.Tensor, gamma: float = 2.5,
                             ksize: int | None = 9) -> torch.Tensor:
    """The brightness attention prior: (1 - V)^gamma, V = max(R, G, B) of
    the median-blurred image."""
    x = median_blur(image, ksize) if ksize else image
    v = x.max(dim=-1, keepdim=True).values
    return torch.pow(1.0 - v, gamma)


_SOBEL = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def boundary_magnitude(image: torch.Tensor, normalized: bool = True) -> torch.Tensor:
    """The Sobel magnitude ``boundary_aware_prior`` thresholds: replicate
    padding, sqrt(gx^2 + gy^2 + 1e-6), over its maximum across the whole
    batch. The taps are summed in the JAX package's order."""
    d = 8.0 if normalized else 1.0
    lead = image.shape[:-3]
    h, w, c = image.shape[-3:]
    x4 = image.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(x4, (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    gx = gy = 0.0
    for i in range(3):
        for j in range(3):
            patch = xp[:, i:i + h, j:j + w, :]
            gx = gx + (_SOBEL[i][j] / d) * patch
            gy = gy + (_SOBEL[j][i] / d) * patch
    g = torch.sqrt(gx * gx + gy * gy + 1e-6)
    return (g / g.max()).reshape(*lead, h, w, c)


def boundary_aware_prior(image: torch.Tensor, eps: float = 0.05,
                         normalized: bool = True) -> torch.Tensor:
    """Thresholded Sobel edge prior: 1 where ``boundary_magnitude`` > eps."""
    return (boundary_magnitude(image, normalized) > eps).to(image.dtype)


# -- window attention (Uformer) ----------------------------------------------

class LinearProjection(nn.Module):
    """Uformer's split projections: ``to_q`` (C -> C) and ``to_kv``
    (C -> 2C), the JAX layer's ``split_qkv=True``."""

    def __init__(self, dim: int, bias: bool = True):
        super().__init__()
        self.to_q = nn.Linear(dim, dim, bias=bias)
        self.to_kv = nn.Linear(dim, 2 * dim, bias=bias)


def relative_position_index(window_size: int) -> torch.Tensor:
    """(ws^2, ws^2) indices into the ((2 ws - 1)^2, heads) bias table: the
    row and column offsets of two window pixels, each shifted by ws - 1,
    in row-major order."""
    ws = window_size
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    diff = flat[:, :, None] - flat[:, None, :] + (ws - 1)
    return diff[0] * (2 * ws - 1) + diff[1]


def make_shift_attn_mask(h: int, w: int, window_size: int, shift: int,
                         device=None) -> torch.Tensor:
    """(windows, ws^2, ws^2) float32: -100 between two pixels of a shifted
    window that come from different regions of the unrolled map, else 0."""
    ws = window_size
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = mw[:, :, None] - mw[:, None, :]
    return torch.where(diff != 0, -100.0, 0.0).to(device=device, dtype=torch.float32)


class WindowAttention(nn.Module):
    """Multi-head self-attention within non-overlapping ws x ws windows of an
    NHWC map, with a relative position bias, optionally shifted.

    Port of ``enhax/nn/layers.py::WindowAttention`` with ``split_qkv=True``
    (Uformer's ``LinearProjection``; the only form the port's models use).
    The reference torch names: ``qkv.to_q``, ``qkv.to_kv``,
    ``relative_position_bias_table`` ((2 ws - 1)^2, heads), ``proj``. The
    index into the table is a constant and not part of the state; a
    released checkpoint's copy of it is dropped on load.

    ``forward(x, mask, shift, modulator)``: with ``shift`` the map is rolled
    by -shift before the windows and back after, and ``mask`` (windows, N,
    N) is added to the logits; ``modulator`` (N, C) is added to every
    window's tokens before the projections (Uformer's decoder blocks). The
    logits q k^T are taken and softmaxed in float32 and the weights cast to
    v's dtype, as the JAX layer takes them with
    ``preferred_element_type=float32``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.qkv = LinearProjection(dim, qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index", relative_position_index(window_size),
                             persistent=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "relative_position_index", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, shift: int = 0,
                modulator: torch.Tensor | None = None) -> torch.Tensor:
        n, h, w, c = x.shape
        ws, heads = self.window_size, self.num_heads
        hd = c // heads
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        nh, nw = h // ws, w // ws
        xw = x.reshape(n, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        if modulator is not None:
            xw = xw + modulator[None]
        q = self.qkv.to_q(xw)
        k, v = self.qkv.to_kv(xw).chunk(2, dim=-1)
        q, k, v = (t.reshape(t.shape[0], ws * ws, heads, hd).transpose(1, 2) for t in (q, k, v))
        attn = (q * hd ** -0.5).float() @ k.float().transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(ws * ws, ws * ws, heads).permute(2, 0, 1).float()[None]
        if shift and mask is not None:
            attn = attn.reshape(n, nh * nw, heads, ws * ws, ws * ws) + mask[None, :, None]
            attn = attn.reshape(-1, heads, ws * ws, ws * ws)
        out = attn.softmax(dim=-1).to(v.dtype) @ v
        out = self.proj(out.transpose(1, 2).reshape(-1, ws * ws, c))
        out = out.reshape(n, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
        if shift:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        return out
