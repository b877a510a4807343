"""NAFNet: nonlinear-activation-free restoration network, with TLC.

Port of ``enhax/models/multitask/nafnet.py``: LayerNorm -> 1x1 -> depthwise
3x3 -> SimpleGate -> simplified channel attention -> 1x1, plus a gated FFN;
a UNet of such blocks with stride-2 conv downs, pixel-shuffle ups and
additive skips. With ``tlc_window`` (NAFNet-TLC, ``nafnet_local``) the
global mean inside the channel attention becomes a local window mean.

Images are NHWC at the module boundary and inside. The parameter names are
the reference torch code's (NAFNet_arch.py): ``intro``, ``encoders.i.j``,
``downs.i``, ``middle_blks.j``, ``ups.i.0``, ``decoders.i.j``, ``ending``;
inside a block ``norm1``, ``conv1``..``conv5``, ``sca.1``, ``beta`` and
``gamma`` of shape (1, C, 1, 1). A released NAFNet-SIDD ``.pth`` loads with
``load_state_dict`` as it is.

The module's forward is the counterpart of the flax module. Inference on a
CUDA tensor takes ``fast_apply_fn``: ``kernels.nafblock.nafnet_fast_apply``,
the fused NAFBlock kernels at C <= 64; so does a training forward with
``fused=True`` (``nafblock_fused``: kernels forward, eager math backward).
The loss is ``psnr_loss`` of ``enhanced`` against ``ref_image``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.kernels.nafblock import nafnet_fast_apply, simple_gate
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import (DWConv3x3, LayerNorm2d, NHWCConv2d, PixelShuffle,
                                   conv1x1, lecun_normal_)
from enhax_torch.nn.losses import psnr_loss
from enhax_torch.ops.filtering import box_filter

__all__ = ["NAFBlock", "NAFNetModule", "simple_gate"]


class Pool(nn.Module):
    """The channel attention's mean: global, or the TLC window mean."""

    def __init__(self, tlc_window: int | None):
        super().__init__()
        self.tlc_window = tlc_window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tlc_window is None:
            return x.mean(dim=(-3, -2), keepdim=True)
        return box_filter(x, self.tlc_window // 2)


class NAFBlock(nn.Module):
    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2,
                 tlc_window: int | None = None):
        super().__init__()
        dw = c * dw_expand
        self.norm1 = LayerNorm2d(c)
        self.conv1 = conv1x1(c, dw)
        self.conv2 = DWConv3x3(dw)
        self.sca = nn.Sequential(Pool(tlc_window), conv1x1(dw // 2, dw // 2))
        self.conv3 = conv1x1(dw // 2, c)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.norm2 = LayerNorm2d(c)
        self.conv4 = conv1x1(c, c * ffn_expand)
        self.conv5 = conv1x1(c * ffn_expand // 2, c)
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = simple_gate(self.conv2(self.conv1(self.norm1(x))))
        y = self.conv3(y * self.sca(y))
        x = x + y * self.beta.reshape(-1)
        y = self.conv5(simple_gate(self.conv4(self.norm2(x))))
        return x + y * self.gamma.reshape(-1)


class NAFNetModule(nn.Module):
    def __init__(self, width: int = 32, middle_blk_num: int = 1,
                 enc_blk_nums=(1, 1, 1, 1), dec_blk_nums=(1, 1, 1, 1),
                 tlc_window: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.tlc_window = tlc_window

        def stage(c, n):
            return nn.Sequential(*(NAFBlock(c, tlc_window=tlc_window) for _ in range(n)))

        c = width
        self.intro = NHWCConv2d(3, c, 3, padding=1)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        for n in enc_blk_nums:
            self.encoders.append(stage(c, n))
            self.downs.append(NHWCConv2d(c, 2 * c, 2, stride=2))
            c *= 2
        self.middle_blks = stage(c, middle_blk_num)
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for n in dec_blk_nums:
            self.ups.append(nn.Sequential(conv1x1(c, 2 * c, bias=False), PixelShuffle(2)))
            c //= 2
            self.decoders.append(stage(c, n))
        self.ending = NHWCConv2d(width, 3, 3, padding=1)
        # flax's defaults: lecun normal kernels, zero biases; LayerNorm and
        # beta/gamma keep their own (ones/zeros)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> dict:
        y = self.intro(x)
        skips = []
        for enc, down in zip(self.encoders, self.downs):
            y = enc(y)
            skips.append(y)
            y = down(y)
        y = self.middle_blks(y)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(skips)):
            y = dec(up(y) + skip)
        return {"enhanced": self.ending(y) + x}


def _nafnet_loss():
    """psnr_loss of ``enhanced`` against ``ref_image``."""
    psnr_l = psnr_loss()

    def fn(outputs, datapoint):
        return psnr_l(outputs["enhanced"], datapoint["ref_image"])
    return fn


def _make(name, width, enc, mid, dec, tlc_window, generator) -> Model:
    return Model(
        name=name, arch="nafnet",
        module=NAFNetModule(width=width, middle_blk_num=mid, enc_blk_nums=enc,
                            dec_blk_nums=dec, tlc_window=tlc_window,
                            generator=generator),
        tasks=(Task.DEBLUR, Task.DENOISE),
        schemes=(Scheme.SUPERVISED,),
        required_inputs=("image",),
        size_divisor=2 ** len(enc),
        fast_apply_fn=nafnet_fast_apply,
        loss_fn=_nafnet_loss(),
    )


@MODELS.register(name="nafnet", arch="nafnet",
                 tasks=(Task.DEBLUR, Task.DENOISE), schemes=(Scheme.SUPERVISED,))
def nafnet(width: int = 32, middle_blk_num: int = 12, enc_blk_nums=(2, 2, 4, 8),
           dec_blk_nums=(2, 2, 2, 2), generator: torch.Generator | None = None,
           **kwargs) -> Model:
    """NAFNet-width32 (the SIDD config of the reference)."""
    return _make("nafnet", width, tuple(enc_blk_nums), middle_blk_num,
                 tuple(dec_blk_nums), None, generator)


@MODELS.register(name="nafnet_local", arch="nafnet",
                 tasks=(Task.DEBLUR, Task.DENOISE), schemes=(Scheme.SUPERVISED,))
def nafnet_local(width: int = 32, middle_blk_num: int = 12, enc_blk_nums=(2, 2, 4, 8),
                 dec_blk_nums=(2, 2, 2, 2), tlc_window: int = 256,
                 generator: torch.Generator | None = None, **kwargs) -> Model:
    """NAFNetLocal: the TLC variant for full-resolution inference."""
    return _make("nafnet_local", width, tuple(enc_blk_nums), middle_blk_num,
                 tuple(dec_blk_nums), tlc_window, generator)
