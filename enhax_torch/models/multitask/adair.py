"""AdaIR: all-in-one restoration by frequency mining and modulation.

Port of ``enhax/models/multitask/adair.py``: a Restormer (the port's
``RestormerBlock``s run as the module's own blocks, as in the JAX package)
with three frequency modules (``fre1`` after the latent, ``fre2``/``fre3``
after the level-3/2 decoders):

  * the split: a learned rate per image (the sigmoid of a 1x1 MLP on the
    mean of a 3x3 conv of the input image, resized bilinearly to the
    feature map) sets a centred box of half-sizes ``int((h // n) * rate)``
    in the shifted spectrum of that conv's output (``fft2``,
    norm="forward"); the low and high parts are the magnitudes of the
    inverse transforms inside and outside the box. The box is empty below
    ``n`` rows or columns (n = ``fre_n``, 128 by default);
  * both parts cross-attend with the feature (channel attention, q from
    one and k, v from the other), are fused by spatial and channel gates,
    and modulate the feature: out * para1 + y * para2 (zeros, ones).

The FFTs take float32 (complex64) whatever the input: the JAX package's
``jnp.fft.fft2`` returns complex64 for bf16, whose magnitudes it casts
back to bf16, and torch's CUDA FFT takes no bf16; the port casts at the
same places. The box is the mask's roll onto the unshifted spectrum, which
is the JAX package's shift, mask and unshift of the spectrum itself.

Images are NHWC throughout. The parameter names are the reference torch
code's (adair/net/model.py): Restormer's (``patch_embed.proj``,
``encoder_level{1,2,3}.j``, ...) and ``fre{1,2,3}.{conv1,rate_conv.{0,2},
channel_cross_{l,h,agg}.{temperature,q,q_dwconv,kv,kv_dwconv,project_out},
frequency_refine.{SpatialGate.spatial,ChannelGate.mlp.{0,2},proj},para1,
para2}``. ``para1``/``para2`` load from any shape of ``dim`` elements.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.models.multitask.restormer import RestormerModule
from enhax_torch.nn.layers import DWConv3x3, NHWCConv2d, conv1x1, gelu_erf, lecun_normal_
from enhax_torch.ops.resize import resize

__all__ = ["AdaIRModule", "frequency_box"]


class _ChannelCrossAttention(nn.Module):
    """q from x, k and v from y: a C x C softmax a head, in the input's
    dtype as the JAX package's einsums take it."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.q = conv1x1(dim, dim, bias=False)
        self.q_dwconv = DWConv3x3(dim, bias=False)
        self.kv = conv1x1(dim, 2 * dim, bias=False)
        self.kv_dwconv = DWConv3x3(2 * dim, bias=False)
        self.project_out = conv1x1(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        heads = self.num_heads

        def split(t):   # (n, heads, c / heads, h * w)
            return t.reshape(n, h * w, heads, c // heads).permute(0, 2, 3, 1)

        q = split(self.q_dwconv(self.q(x)))
        k, v = (split(t) for t in self.kv_dwconv(self.kv(y)).chunk(2, dim=-1))
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        attn = ((q @ k.transpose(-2, -1)) * self.temperature).softmax(dim=-1)
        out = (attn @ v).permute(0, 3, 1, 2).reshape(n, h, w, c)
        return self.project_out(out)


class _SpatialGate(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = NHWCConv2d(2, 1, 7, padding=3, bias=False)


class _ChannelGate(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        hidden = max(dim // 16, 1)
        self.mlp = nn.Sequential(conv1x1(dim, hidden, bias=False), nn.ReLU(),
                                 conv1x1(hidden, dim, bias=False))


class _FreRefine(nn.Module):
    """The high part's spatial gate on the low, the low part's channel gate
    (one MLP on its mean and its max) on the high, summed and projected."""

    def __init__(self, dim: int):
        super().__init__()
        self.SpatialGate = _SpatialGate()
        self.ChannelGate = _ChannelGate(dim)
        self.proj = conv1x1(dim, dim)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([high.amax(dim=-1, keepdim=True), high.mean(dim=-1, keepdim=True)],
                           dim=-1)
        sw = torch.sigmoid(self.SpatialGate.spatial(pooled))
        mlp = self.ChannelGate.mlp
        cw = torch.sigmoid(mlp(low.mean(dim=(-3, -2), keepdim=True))
                           + mlp(low.amax(dim=(-3, -2), keepdim=True)))
        return self.proj(low * sw + high * cw)


def frequency_box(rate: torch.Tensor, h: int, w: int, n: int) -> tuple:
    """The box's half-sizes (h_, w_) a batch row from the rates (B, 2):
    ``int((h // n) * rate)``, truncated as the JAX package's cast."""
    return (((h // n) * rate[:, 0]).to(torch.int32),
            ((w // n) * rate[:, 1]).to(torch.int32))


class _FreModule(nn.Module):
    def __init__(self, dim: int, num_heads: int, n: int = 128):
        super().__init__()
        self.dim, self.n = dim, n
        self.conv1 = NHWCConv2d(3, dim, 3, padding=1, bias=False)
        self.rate_conv = nn.Sequential(conv1x1(dim, max(dim // 8, 1), bias=False), nn.GELU(),
                                       conv1x1(max(dim // 8, 1), 2, bias=False))
        self.channel_cross_l = _ChannelCrossAttention(dim, num_heads)
        self.channel_cross_h = _ChannelCrossAttention(dim, num_heads)
        self.channel_cross_agg = _ChannelCrossAttention(dim, num_heads)
        self.frequency_refine = _FreRefine(dim)
        self.para1 = nn.Parameter(torch.zeros(dim))
        self.para2 = nn.Parameter(torch.ones(dim))

    def split(self, z: torch.Tensor) -> tuple:
        """(low, high) of ``z`` (B, H, W, C), in z's dtype."""
        b, h, w, _ = z.shape
        r1, _, r2 = self.rate_conv
        rate = torch.sigmoid(r2(gelu_erf(r1(z.mean(dim=(-3, -2), keepdim=True)))))[:, 0, 0, :]
        h_, w_ = frequency_box(rate, h, w, self.n)
        rows = torch.arange(h, device=z.device)[None, :]
        cols = torch.arange(w, device=z.device)[None, :]
        rmask = (rows >= h // 2 - h_[:, None]) & (rows < h // 2 + h_[:, None])
        cmask = (cols >= w // 2 - w_[:, None]) & (cols < w // 2 + w_[:, None])
        mask = (rmask[:, :, None] & cmask[:, None, :])[..., None].float()
        # the mask on the shifted spectrum, rolled back onto the unshifted one
        mask = torch.roll(mask, (-(h // 2), -(w // 2)), dims=(1, 2))
        f = torch.fft.fft2(z.to(torch.promote_types(z.dtype, torch.float32)), dim=(1, 2),
                           norm="forward")
        high = torch.fft.ifft2(f * (1 - mask), dim=(1, 2), norm="forward").abs().to(z.dtype)
        low = torch.fft.ifft2(f * mask, dim=(1, 2), norm="forward").abs().to(z.dtype)
        return low, high

    def forward(self, img: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = resize(img, (y.shape[-3], y.shape[-2]), method="bilinear")
        low, high = self.split(self.conv1(x))
        high_f = self.channel_cross_l(high, y)
        low_f = self.channel_cross_h(low, y)
        agg = self.frequency_refine(low_f, high_f)
        return self.channel_cross_agg(y, agg) * self.para1 + y * self.para2

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("para1", "para2"):
            t = state_dict.get(prefix + name)
            if t is not None and t.numel() == self.dim:
                state_dict[prefix + name] = t.reshape(self.dim)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class AdaIRModule(RestormerModule):
    def __init__(self, dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement: int = 4,
                 heads=(1, 2, 4, 8), expansion: float = 2.66, decoder: bool = True,
                 fre_n: int = 128, generator: torch.Generator | None = None):
        super().__init__(dim, num_blocks, num_refinement, heads, expansion, generator)
        self.decoder = decoder
        if decoder:
            self.fre1 = _FreModule(8 * dim, heads[2], fre_n)
            self.fre2 = _FreModule(4 * dim, heads[2], fre_n)
            self.fre3 = _FreModule(2 * dim, heads[2], fre_n)
            # flax's default: lecun normal kernels, zero biases
            with torch.no_grad():
                for fre in (self.fre1, self.fre2, self.fre3):
                    for m in fre.modules():
                        if isinstance(m, nn.Conv2d):
                            lecun_normal_(m.weight, generator)
                            if m.bias is not None:
                                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> dict:
        enc, dec = self.levels()
        y = self.patch_embed(x)
        skips = []
        for encoder, down in enc:
            y = encoder(y)
            skips.append(y)
            y = down(y)
        y = self.latent(y)
        if self.decoder:
            y = self.fre1(x, y)
        fres = (self.fre2, self.fre3, None) if self.decoder else (None,) * 3
        for (up, reduce, decoder), skip, fre in zip(dec, reversed(skips), fres):
            y = torch.cat([up(y), skip], dim=-1)
            if reduce is not None:
                y = reduce(y)
            y = decoder(y)
            if fre is not None:
                y = fre(x, y)
        y = self.refinement(y)
        return {"enhanced": self.output(y) + x}


def _l1_loss():
    def fn(outputs, datapoint):
        target = datapoint.get("ref_image", datapoint["image"])
        return (outputs["enhanced"] - target).abs().mean()
    return fn


@MODELS.register(name="adair", arch="adair",
                 tasks=(Task.DENOISE, Task.DERAIN, Task.DEHAZE, Task.DEBLUR, Task.LLIE),
                 schemes=(Scheme.SUPERVISED,))
def adair(dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement: int = 4, heads=(1, 2, 4, 8),
          expansion: float = 2.66, decoder: bool = True, fre_n: int = 128,
          generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="adair", arch="adair",
        module=AdaIRModule(dim=dim, num_blocks=tuple(num_blocks), num_refinement=num_refinement,
                           heads=tuple(heads), expansion=expansion, decoder=decoder,
                           fre_n=fre_n, generator=generator),
        tasks=(Task.DENOISE, Task.DERAIN, Task.DEHAZE, Task.DEBLUR, Task.LLIE),
        schemes=(Scheme.SUPERVISED,),
        loss_fn=_l1_loss(),
        required_inputs=("image",),
        size_divisor=8,
    )
