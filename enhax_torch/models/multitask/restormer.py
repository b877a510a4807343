"""Restormer: an efficient transformer for high-resolution restoration.

Port of ``enhax/models/multitask/restormer.py``: MDTA (transposed
attention over the channels, linear in pixels) and GDFN (gated depthwise
FFN) blocks in a 4-level UNet with pixel-(un)shuffle resampling. Served
overlap-tiled through ``Predictor(tile=...)`` (``infer/tiling.py``).

Images are NHWC at the module boundary and inside. The parameter names are
the reference torch code's (restormer_arch.py): ``patch_embed.proj``,
``encoder_level{1..3}.j``, ``latent.j``, ``decoder_level{1..3}.j``,
``refinement.j``, ``down{1_2,2_3,3_4}.body.0``, ``up{2_1,3_2,4_3}.body.0``,
``reduce_chan_level{2,3}``, ``output``; inside a block ``norm1.body``,
``attn.{temperature,qkv,qkv_dwconv,project_out}``, ``norm2.body``,
``ffn.{project_in,dwconv,project_out}``. No conv has a bias.

The module's forward is the counterpart of the flax module. Inference on a
CUDA tensor takes ``fast_apply_fn``:
``kernels.restormer_block.restormer_fast_apply``, the fused blocks R1 -> glue
-> R2 where the spatial size is at least ``fused_min_hw``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.kernels.restormer_block import restormer_fast_apply
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import (DWConv3x3, NHWCConv2d, PixelShuffle, PixelUnshuffle,
                                   WithBiasLayerNorm, conv1x1, gelu_erf, lecun_normal_)

__all__ = ["GDFN", "MDTA", "RestormerBlock", "RestormerModule"]


class MDTA(nn.Module):
    """Multi-dconv-head transposed attention: softmax over a C x C gram."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = conv1x1(dim, 3 * dim, bias=False)
        self.qkv_dwconv = DWConv3x3(3 * dim, bias=False)
        self.project_out = conv1x1(dim, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        hd = c // self.num_heads
        # the JAX module's pixel-major layout: contract the pixel axis
        t = self.qkv_dwconv(self.qkv(x)).reshape(n, h * w, 3, self.num_heads, hd)
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-6)
        k = k / k.norm(dim=1, keepdim=True).clamp_min(1e-6)
        attn = torch.einsum("nphc,nphd->nhcd", q.float(), k.float()) * self.temperature
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("nhcd,nphd->nphc", attn, v).reshape(n, h, w, c)
        return self.project_out(out)


class GDFN(nn.Module):
    """Gated dconv feed-forward network."""

    def __init__(self, dim: int, expansion: float = 2.66):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = conv1x1(dim, 2 * hidden, bias=False)
        self.dwconv = DWConv3x3(2 * hidden, bias=False)
        self.project_out = conv1x1(hidden, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.dwconv(self.project_in(x)).chunk(2, dim=-1)
        return self.project_out(gelu_erf(a) * b)


class RestormerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66):
        super().__init__()
        self.norm1 = WithBiasLayerNorm(dim)
        self.attn = MDTA(dim, num_heads)
        self.norm2 = WithBiasLayerNorm(dim)
        self.ffn = GDFN(dim, expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = NHWCConv2d(3, dim, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class _Resample(nn.Module):
    """Downsample (3x3 conv n -> n/2, unshuffle) or Upsample (n -> 2n, shuffle)."""

    def __init__(self, n: int, down: bool):
        super().__init__()
        out = n // 2 if down else 2 * n
        self.body = nn.Sequential(NHWCConv2d(n, out, 3, padding=1, bias=False),
                                  PixelUnshuffle(2) if down else PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class RestormerModule(nn.Module):
    def __init__(self, dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement: int = 4,
                 heads=(1, 2, 4, 8), expansion: float = 2.66,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = dim

        def stage(c, n, nh):
            return nn.Sequential(*(RestormerBlock(c, nh, expansion) for _ in range(n)))

        self.patch_embed = _PatchEmbed(d)
        self.encoder_level1 = stage(d, num_blocks[0], heads[0])
        self.down1_2 = _Resample(d, down=True)
        self.encoder_level2 = stage(2 * d, num_blocks[1], heads[1])
        self.down2_3 = _Resample(2 * d, down=True)
        self.encoder_level3 = stage(4 * d, num_blocks[2], heads[2])
        self.down3_4 = _Resample(4 * d, down=True)
        self.latent = stage(8 * d, num_blocks[3], heads[3])
        self.up4_3 = _Resample(8 * d, down=False)
        self.reduce_chan_level3 = conv1x1(8 * d, 4 * d, bias=False)
        self.decoder_level3 = stage(4 * d, num_blocks[2], heads[2])
        self.up3_2 = _Resample(4 * d, down=False)
        self.reduce_chan_level2 = conv1x1(4 * d, 2 * d, bias=False)
        self.decoder_level2 = stage(2 * d, num_blocks[1], heads[1])
        self.up2_1 = _Resample(2 * d, down=False)
        # level 1 runs its decoder on the 2d-wide concat: no reduce conv
        self.decoder_level1 = stage(2 * d, num_blocks[0], heads[0])
        self.refinement = stage(2 * d, num_refinement, heads[0])
        self.output = NHWCConv2d(2 * d, 3, 3, padding=1, bias=False)
        # flax's default: lecun normal kernels; temperature and LayerNorm
        # keep their own (ones/zeros)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)

    def levels(self):
        """(encoder, down) pairs, then (up, reduce or None, decoder) from the
        deepest level up: the order of the forward."""
        enc = [(self.encoder_level1, self.down1_2), (self.encoder_level2, self.down2_3),
               (self.encoder_level3, self.down3_4)]
        dec = [(self.up4_3, self.reduce_chan_level3, self.decoder_level3),
               (self.up3_2, self.reduce_chan_level2, self.decoder_level2),
               (self.up2_1, None, self.decoder_level1)]
        return enc, dec

    def forward(self, x: torch.Tensor, block=None) -> dict:
        """``block(y, blk)`` runs one RestormerBlock (default: its forward)."""
        block = block or (lambda y, blk: blk(y))

        def stage(y, seq):
            for blk in seq:
                y = block(y, blk)
            return y

        enc, dec = self.levels()
        y = self.patch_embed(x)
        skips = []
        for encoder, down in enc:
            y = stage(y, encoder)
            skips.append(y)
            y = down(y)
        y = stage(y, self.latent)
        for (up, reduce, decoder), skip in zip(dec, reversed(skips)):
            y = torch.cat([up(y), skip], dim=-1)
            if reduce is not None:
                y = reduce(y)
            y = stage(y, decoder)
        y = stage(y, self.refinement)
        return {"enhanced": self.output(y) + x}


@MODELS.register(name="restormer", arch="restormer",
                 tasks=(Task.DERAIN, Task.DENOISE, Task.DEBLUR, Task.DEHAZE),
                 schemes=(Scheme.SUPERVISED,))
def restormer(dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement: int = 4,
              heads=(1, 2, 4, 8), expansion: float = 2.66,
              generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="restormer", arch="restormer",
        module=RestormerModule(dim=dim, num_blocks=tuple(num_blocks),
                               num_refinement=num_refinement, heads=tuple(heads),
                               expansion=expansion, generator=generator),
        tasks=(Task.DERAIN, Task.DENOISE, Task.DEBLUR, Task.DEHAZE),
        schemes=(Scheme.SUPERVISED,),
        required_inputs=("image",),
        size_divisor=8,
        fast_apply_fn=restormer_fast_apply,
    )
