"""HVI-CIDNet: a dual-branch colour/intensity transformer in HVI space.

Port of ``enhax/models/llie/hvi_cidnet.py``: RGB -> HVI (learnable
``density_k``); an HV (2-channel) and an I (1-channel) encoder-decoder
pyramid coupled at every level by lightweight cross attention (``LCA``:
``CrossCAB``, channel-wise transposed cross attention with L2-normalised q
and k and a per-head temperature, the logits in float32 before the softmax;
then ``IEL``, a gated tanh-residual depthwise FFN); the residual in HVI
space, back to RGB. The module holds NCHW maps; in and out NHWC.

Parameter names are the reference's (``hve_block0.1``, ``ie_block1.down.0``,
``hvd_block3.up_scale.0``/``.up``, ``ffn.q_dwconv``/``kv_dwconv``,
``prelu.weight``, ``trans.density_k``), so a released ``.pth`` loads as it
is. The attention is plain ``torch.matmul``/``softmax``: the JAX package
computes it in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.models.llie.lllinet import DensityK
from enhax_torch.nn.layers import LayerNorm2d, flax_conv2d
from enhax_torch.ops.color import hvi_to_rgb, rgb_to_hvi


def _conv(cin: int, cout: int, k: int, g, groups: int = 1, padding: int | None = None):
    return flax_conv2d(cin, cout, k, groups=groups, bias=False, padding=padding, generator=g)


def _resize_ac(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, align_corners=True (the reference's UpsamplingBilinear2d)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class PReLU(nn.Module):
    """torch's ``nn.PReLU()``: one alpha shared by every channel, 0.25."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class CrossCAB(nn.Module):
    """Cross attention over channels: q from x, k and v from y."""

    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        g = generator
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = _conv(dim, dim, 1, g)
        self.q_dwconv = _conv(dim, dim, 3, g, groups=dim)
        self.kv = _conv(dim, 2 * dim, 1, g)
        self.kv_dwconv = _conv(2 * dim, 2 * dim, 3, g, groups=2 * dim)
        self.project_out = _conv(dim, dim, 1, g)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        q = self.q_dwconv(self.q(x))
        k, v = self.kv_dwconv(self.kv(y)).chunk(2, dim=1)
        q, k, v = (t.reshape(n, self.num_heads, c // self.num_heads, h * w) for t in (q, k, v))
        q = F.normalize(q, dim=-1, eps=1e-6)
        k = F.normalize(k, dim=-1, eps=1e-6)
        wide = torch.promote_types(q.dtype, torch.float32)   # logits in float32 at least
        attn = torch.matmul(q.to(wide), k.to(wide).transpose(-2, -1)) * self.temperature
        attn = attn.softmax(dim=-1).to(v.dtype)
        return self.project_out(torch.matmul(attn, v).reshape(n, c, h, w))


class IEL(nn.Module):
    """Intensity enhancement layer: gated tanh-residual depthwise FFN."""

    def __init__(self, dim: int, expansion: float = 2.66, generator=None):
        super().__init__()
        g, hidden = generator, int(dim * expansion)
        self.project_in = _conv(dim, 2 * hidden, 1, g)
        self.dwconv = _conv(2 * hidden, 2 * hidden, 3, g, groups=2 * hidden)
        self.dwconv1 = _conv(hidden, hidden, 3, g, groups=hidden)
        self.dwconv2 = _conv(hidden, hidden, 3, g, groups=hidden)
        self.project_out = _conv(hidden, dim, 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        x1 = torch.tanh(self.dwconv1(x1)) + x1
        x2 = torch.tanh(self.dwconv2(x2)) + x2
        return self.project_out(x1 * x2)


class LCA(nn.Module):
    """I_LCA (``residual_ffn``) / HV_LCA: one LayerNorm for both inputs and
    the attention's output, cross attention, then ``IEL``."""

    def __init__(self, dim: int, num_heads: int, residual_ffn: bool = True, generator=None):
        super().__init__()
        self.residual_ffn = residual_ffn
        self.norm = LayerNorm2d(dim, eps=1e-5)
        self.ffn = CrossCAB(dim, num_heads, generator)
        self.gdfn = IEL(dim, generator=generator)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a = a + self.ffn(self._norm(a), self._norm(b))
        g = self.gdfn(self._norm(a))
        return a + g if self.residual_ffn else g


class DownsampleNorm(nn.Module):
    """3x3 conv, a bilinear (align_corners) halving, PReLU."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.down = nn.Sequential(_conv(cin, cout, 3, generator))
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.down(x)
        return self.prelu(_resize_ac(y, (y.shape[-2] // 2, y.shape[-1] // 2)))


class UpsampleNorm(nn.Module):
    """3x3 conv, a bilinear (align_corners) resize to the skip, a 1x1 over
    [y, skip], PReLU."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.up_scale = nn.Sequential(_conv(cin, cout, 3, generator))
        self.up = _conv(2 * cout, cout, 1, generator)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = _resize_ac(self.up_scale(x), skip.shape[-2:])
        return self.prelu(self.up(torch.cat([y, skip], 1)))


def _conv_rep(cin: int, cout: int, g) -> nn.Sequential:
    """Replicate padding, then a 3x3 conv without padding."""
    return nn.Sequential(nn.ReplicationPad2d(1), _conv(cin, cout, 3, g, padding=0))


class CIDNetModule(nn.Module):
    """NHWC image -> {"enhanced", "hvi"}."""

    def __init__(self, channels: tuple = (36, 36, 72, 144), heads: tuple = (1, 2, 4, 8),
                 density_k: float = 0.2, generator: torch.Generator | None = None):
        super().__init__()
        ch1, ch2, ch3, ch4 = channels
        _, h2, h3, h4 = heads
        g = generator
        self.trans = DensityK(density_k)
        self.hve_block0 = _conv_rep(3, ch1, g)
        self.hve_block1 = DownsampleNorm(ch1, ch2, g)
        self.hve_block2 = DownsampleNorm(ch2, ch3, g)
        self.hve_block3 = DownsampleNorm(ch3, ch4, g)
        self.hvd_block3 = UpsampleNorm(ch4, ch3, g)
        self.hvd_block2 = UpsampleNorm(ch3, ch2, g)
        self.hvd_block1 = UpsampleNorm(ch2, ch1, g)
        self.hvd_block0 = _conv_rep(ch1, 2, g)
        self.ie_block0 = _conv_rep(1, ch1, g)
        self.ie_block1 = DownsampleNorm(ch1, ch2, g)
        self.ie_block2 = DownsampleNorm(ch2, ch3, g)
        self.ie_block3 = DownsampleNorm(ch3, ch4, g)
        self.id_block3 = UpsampleNorm(ch4, ch3, g)
        self.id_block2 = UpsampleNorm(ch3, ch2, g)
        self.id_block1 = UpsampleNorm(ch2, ch1, g)
        self.id_block0 = _conv_rep(ch1, 1, g)
        for i, (ch, hd) in enumerate([(ch2, h2), (ch3, h3), (ch4, h4), (ch4, h4), (ch3, h3),
                                      (ch2, h2)], start=1):
            setattr(self, f"hv_lca{i}", LCA(ch, hd, False, g))
            setattr(self, f"i_lca{i}", LCA(ch, hd, True, g))

    def forward(self, x: torch.Tensor) -> dict:
        kv = self.trans.density_k[0]
        hvi = rgb_to_hvi(x, density_k=kv)
        hvi_c = hvi.permute(0, 3, 1, 2)
        i = hvi_c[:, 2:3]

        i_enc0 = self.ie_block0(i)
        i_enc1 = self.ie_block1(i_enc0)
        hv_0 = self.hve_block0(hvi_c)
        hv_1 = self.hve_block1(hv_0)

        i_enc2 = self.i_lca1(i_enc1, hv_1)
        hv_2 = self.hv_lca1(hv_1, i_enc1)
        v_jump1, hv_jump1 = i_enc2, hv_2
        i_enc2 = self.ie_block2(i_enc2)
        hv_2 = self.hve_block2(hv_2)

        i_enc3 = self.i_lca2(i_enc2, hv_2)
        hv_3 = self.hv_lca2(hv_2, i_enc2)
        v_jump2, hv_jump2 = i_enc3, hv_3
        i_enc3 = self.ie_block3(i_enc2)
        hv_3 = self.hve_block3(hv_2)

        i_enc4 = self.i_lca3(i_enc3, hv_3)
        hv_4 = self.hv_lca3(hv_3, i_enc3)

        i_dec4 = self.i_lca4(i_enc4, hv_4)
        hv_4 = self.hv_lca4(hv_4, i_enc4)

        hv_3 = self.hvd_block3(hv_4, hv_jump2)
        i_dec3 = self.id_block3(i_dec4, v_jump2)
        i_dec2 = self.i_lca5(i_dec3, hv_3)
        hv_2 = self.hv_lca5(hv_3, i_dec3)

        hv_2 = self.hvd_block2(hv_2, hv_jump1)
        i_dec2 = self.id_block2(i_dec3, v_jump1)

        i_dec1 = self.i_lca6(i_dec2, hv_2)
        hv_1 = self.hv_lca6(hv_2, i_dec2)

        i_dec1 = self.id_block1(i_dec1, i_enc0)
        i_dec0 = self.id_block0(i_dec1)
        hv_1 = self.hvd_block1(hv_1, hv_0)
        hv_0 = self.hvd_block0(hv_1)

        output_hvi = torch.cat([hv_0, i_dec0], 1).permute(0, 2, 3, 1) + hvi
        return {"enhanced": hvi_to_rgb(output_hvi, density_k=kv), "hvi": output_hvi}


def cidnet_loss(l1_w: float = 1.0, ssim_w: float = 0.5, edge_w: float = 50.0,
                per_w: float = 0.01, hvi_weight: float = 1.0):
    """(L1 + 0.5 SSIM + 50 edge + 0.01 perceptual) on RGB, plus the same on
    HVI (the prediction clipped to [0, 1] first) times ``hvi_weight``."""
    l1, ssim_l = LOSSES.build("l1_loss"), LOSSES.build("ssim_loss")
    edge, per = LOSSES.build("edge_loss"), LOSSES.build("perceptual_loss")

    def composite(a, b):
        return (l1_w * l1(a, b) + ssim_w * ssim_l(a, b) + edge_w * edge(a, b)
                + per_w * per(a, b))

    def fn(outputs, datapoint):
        pred, target = outputs["enhanced"], datapoint["ref_image"]
        return composite(pred, target) + hvi_weight * composite(
            rgb_to_hvi(pred.clamp(0, 1)), rgb_to_hvi(target))
    return fn


@MODELS.register(name="hvi_cidnet_re", arch="hvi_cidnet", aliases=["hvi_cidnet"],
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,))
def hvi_cidnet_re(channels=(36, 36, 72, 144), heads=(1, 2, 4, 8), hvi_weight: float = 1.0,
                  generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(name="hvi_cidnet_re", arch="hvi_cidnet",
                 module=CIDNetModule(channels=tuple(channels), heads=tuple(heads),
                                     generator=generator),
                 tasks=(Task.LLIE,), schemes=(Scheme.SUPERVISED,),
                 loss_fn=cidnet_loss(hvi_weight=hvi_weight), required_inputs=("image",),
                 size_divisor=8)
