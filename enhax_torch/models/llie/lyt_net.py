"""LYT-Net: a YUV transformer for low-light enhancement.

Port of ``enhax/models/llie/lyt_net.py``: Y, Cb and Cr apart; Cb and Cr each
through a small stride-2 UNet denoiser with an MHSA bottleneck; a fusion
block (``MSEF``) and a luminance path pooled 8x8 through MHSA; a sigmoid
output. The module holds NCHW maps; in and out NHWC.

``MHSA`` builds its tokens as the reference does, from the contiguous NCHW
tensor reshaped to (B, H*W, C), which mixes channels and pixels (released
weights embed that layout). Its attention is plain ``torch.matmul`` and
``softmax`` over all H*W tokens (logits in float32), as the JAX package
computes it in XLA. Upsampling is half-pixel nearest (``nearest-exact``,
``jax.image.resize``'s). Parameter names are the reference's
(``process_y.0``, ``query_dense``, ``combine_heads``,
``msef.layer_norm.norm``, ``depthwise_conv``, ``se_attn``), so a released
``.pth`` loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import dense
from enhax_torch.nn.layers import flax_conv2d


def _nearest(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class MHSA(nn.Module):
    """Multi-head self attention over the flattened pixels of an NCHW map."""

    def __init__(self, embed_size: int, num_heads: int = 4, generator=None):
        super().__init__()
        g = generator
        self.embed_size, self.num_heads = embed_size, num_heads
        self.query_dense = dense(embed_size, embed_size, generator=g)
        self.key_dense = dense(embed_size, embed_size, generator=g)
        self.value_dense = dense(embed_size, embed_size, generator=g)
        self.combine_heads = dense(embed_size, embed_size, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        t = x.reshape(n, h * w, c)   # the reference's view of the NCHW tensor
        hd = self.embed_size // self.num_heads

        def heads(lin):
            return lin(t).reshape(n, h * w, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query_dense), heads(self.key_dense), heads(self.value_dense)
        wide = torch.promote_types(q.dtype, torch.float32)   # logits in float32 at least
        attn = torch.matmul(q.to(wide), k.to(wide).transpose(-2, -1)) / hd ** 0.5
        out = torch.matmul(attn.softmax(dim=-1).to(v.dtype), v)
        out = self.combine_heads(out.transpose(1, 2).reshape(n, h * w, self.embed_size))
        return out.reshape(n, h, w, self.embed_size).permute(0, 3, 1, 2)


class SETanh(nn.Module):
    """Squeeze-excite with a tanh gate."""

    def __init__(self, channels: int, reduction: int = 16, generator=None):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc1 = dense(channels, mid, generator=generator)
        self.fc2 = dense(mid, channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.tanh(self.fc2(F.relu(self.fc1(x.mean(dim=(-2, -1))))))
        return x * s[:, :, None, None]


class _LayerNormWrap(nn.Module):
    """The reference's ``layer_norm.norm``: LayerNorm over channels, flax's
    eps 1e-6."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = nn.LayerNorm(channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MSEF(nn.Module):
    """Multi-scale enhancement fusion: LayerNorm, then a depthwise 3x3 times
    the SE gate, plus the input."""

    def __init__(self, filters: int, generator=None):
        super().__init__()
        self.layer_norm = _LayerNormWrap(filters)
        self.depthwise_conv = flax_conv2d(filters, filters, 3, groups=filters,
                                          generator=generator)
        self.se_attn = SETanh(filters, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = self.layer_norm(x)
        return self.depthwise_conv(xn) * self.se_attn(xn) + x


class ChannelDenoiser(nn.Module):
    """Stride-2 UNet of one channel with an MHSA bottleneck."""

    def __init__(self, filters: int, generator=None):
        super().__init__()
        g, f = generator, filters
        self.conv1 = flax_conv2d(1, f, 3, generator=g)
        self.conv2 = flax_conv2d(f, f, 3, stride=2, padding=1, generator=g)
        self.conv3 = flax_conv2d(f, f, 3, stride=2, padding=1, generator=g)
        self.conv4 = flax_conv2d(f, f, 3, stride=2, padding=1, generator=g)
        self.bottleneck = MHSA(f, 4, g)
        self.res_layer = flax_conv2d(f, 1, 3, generator=g)
        self.output_layer = flax_conv2d(1, 1, 3, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = F.relu(self.conv1(x))
        x2 = F.relu(self.conv2(x1))
        x3 = F.relu(self.conv3(x2))
        x4 = F.relu(self.conv4(x3))
        y = _nearest(self.bottleneck(x4), x3.shape[-2:])
        y = _nearest(y + x3, x2.shape[-2:])
        y = _nearest(y + x2, x1.shape[-2:]) + x1
        y = self.res_layer(y)
        return torch.tanh(self.output_layer(y + y))


class LYTNetModule(nn.Module):
    """NHWC image -> {"enhanced"}."""

    def __init__(self, filters: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        g, f = generator, filters
        self.denoiser_cb = ChannelDenoiser(f // 2, g)
        self.denoiser_cr = ChannelDenoiser(f // 2, g)
        self.process_y = nn.Sequential(flax_conv2d(1, f, 3, generator=g))
        self.process_cb = nn.Sequential(flax_conv2d(1, f, 3, generator=g))
        self.process_cr = nn.Sequential(flax_conv2d(1, f, 3, generator=g))
        self.lum_mhsa = MHSA(f, 4, g)
        self.ref_conv = flax_conv2d(2 * f, f, 1, generator=g)
        self.lum_conv = flax_conv2d(f, f, 1, generator=g)
        self.msef = MSEF(f, g)
        self.recombine = flax_conv2d(2 * f, f, 3, generator=g)
        self.final_adjustments = flax_conv2d(f, 3, 3, generator=g)

    def forward(self, x: torch.Tensor) -> dict:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = (0.299 * r + 0.587 * g + 0.114 * b)[:, None]
        cb = (-0.14713 * r - 0.28886 * g + 0.436 * b + 0.5)[:, None]
        cr = (0.615 * r - 0.51499 * g - 0.10001 * b + 0.5)[:, None]
        cb = self.denoiser_cb(cb) + cb
        cr = self.denoiser_cr(cr) + cr

        y_p = F.relu(self.process_y(y))
        cb_p = F.relu(self.process_cb(cb))
        cr_p = F.relu(self.process_cr(cr))

        lum = y_p
        lum_1 = self.lum_mhsa(F.max_pool2d(lum, 8))
        lum = lum + _nearest(lum_1, lum.shape[-2:])

        ref = self.ref_conv(torch.cat([cb_p, cr_p], 1))
        shortcut = ref
        ref = ref + 0.2 * self.lum_conv(lum)
        ref = self.msef(ref) + shortcut

        rec = self.recombine(torch.cat([ref, lum], 1))
        out = self.final_adjustments(rec)
        return {"enhanced": torch.sigmoid(out).permute(0, 2, 3, 1)}


def lyt_loss(a1=1.0, a2=0.06, a3=0.05, a4=0.5, a5=0.0083, a6=0.25):
    """smooth-L1 + 0.06 perceptual + 0.05 histogram + 0.5 MS-SSIM + 0.0083
    PSNR + 0.25 colour."""
    sl1, per = LOSSES.build("smooth_l1_loss"), LOSSES.build("perceptual_loss")
    hist, msss = LOSSES.build("histogram_loss"), LOSSES.build("ms_ssim_loss")
    psnr_l, col = LOSSES.build("psnr_loss"), LOSSES.build("color_loss")

    def fn(outputs, datapoint):
        p, t = outputs["enhanced"], datapoint["ref_image"]
        return (a1 * sl1(p, t) + a2 * per(p, t) + a3 * hist(p, t)
                + a4 * msss(p, t) + a5 * psnr_l(p, t) + a6 * col(p, t))
    return fn


@MODELS.register(name="lyt_net_re", arch="lyt_net", aliases=["lyt_net"],
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,))
def lyt_net_re(filters: int = 32, generator: torch.Generator | None = None,
               **kwargs) -> Model:
    return Model(name="lyt_net_re", arch="lyt_net",
                 module=LYTNetModule(filters=filters, generator=generator),
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,), loss_fn=lyt_loss(),
                 required_inputs=("image",), size_divisor=64)
