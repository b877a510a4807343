"""HINet: half-instance-normalization two-stage UNet.

Port of ``enhax/models/multitask/hinet.py``: two UNet stages bridged by a
supervised attention module (SAM) and cross-stage feature fusion (CSFF);
instance norm on the first half of the channels of each encoder block at
``in_pos_left <= i <= in_pos_right`` (the "HIN" trick). Outputs ``stage1``
(the SAM's image) and ``enhanced``; the loss is ``psnr_loss`` of each
against ``ref_image``, summed.

Images are NHWC at the module boundary; inside, the convs run on the NCHW
view of the NHWC tensor (channels_last in memory), so the instance norm
reduces over the last two axes. The parameter names are the reference
torch code's (hinet_arch.py): ``conv_01``, ``conv_02``,
``down_path_{1,2}.i.{identity,conv_1,conv_2,norm,csff_enc,csff_dec,
downsample}``, ``up_path_{1,2}.i.{up,conv_block.*}``, ``skip_conv_{1,2}.i``,
``sam12.conv{1,2,3}``, ``cat12``, ``last``; a released ``.pth`` loads with
``load_state_dict`` as it is. The model has no kernel and no fused path:
its convs go to cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import InstanceNorm2d, conv3x3, lecun_normal_
from enhax_torch.nn.losses import psnr_loss

__all__ = ["HINConvBlock", "HINUpBlock", "HINetModule", "SAM"]


class HINConvBlock(nn.Module):
    """UNetConvBlock: two 3x3 convs with LeakyReLU and a 1x1 identity, the
    instance norm on half the channels after the first conv, the CSFF convs
    of stage 2 and the 4x4 stride-2 down conv (no bias)."""

    def __init__(self, in_ch: int, out_ch: int, downsample: bool, relu_slope: float = 0.2,
                 use_csff: bool = False, use_hin: bool = False):
        super().__init__()
        self.relu_slope = relu_slope
        self.identity = nn.Conv2d(in_ch, out_ch, 1)
        self.conv_1 = conv3x3(in_ch, out_ch)
        self.conv_2 = conv3x3(out_ch, out_ch)
        self.norm = InstanceNorm2d(out_ch // 2) if use_hin else None
        if downsample and use_csff:
            self.csff_enc = conv3x3(out_ch, out_ch)
            self.csff_dec = conv3x3(out_ch, out_ch)
        self.downsample = (nn.Conv2d(out_ch, out_ch, 4, stride=2, padding=1, bias=False)
                           if downsample else None)

    def forward(self, x, enc=None, dec=None):
        y = self.conv_1(x)
        if self.norm is not None:
            y1, y2 = torch.chunk(y, 2, dim=1)
            y = torch.cat([self.norm(y1), y2], dim=1)
        y = F.leaky_relu(y, self.relu_slope)
        y = F.leaky_relu(self.conv_2(y), self.relu_slope)
        y = y + self.identity(x)
        if enc is not None and dec is not None:
            y = y + self.csff_enc(enc) + self.csff_dec(dec)
        if self.downsample is not None:
            return self.downsample(y), y
        return y


class HINUpBlock(nn.Module):
    """UNetUpBlock: a 2x2 stride-2 transposed conv, the bridge concatenated,
    a conv block."""

    def __init__(self, in_ch: int, out_ch: int, relu_slope: float = 0.2):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)
        self.conv_block = HINConvBlock(in_ch, out_ch, False, relu_slope)

    def forward(self, x, bridge):
        return self.conv_block(torch.cat([self.up(x), bridge], dim=1))


class SAM(nn.Module):
    """Supervised attention module: the stage-1 image and the features it
    gates for stage 2."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = conv3x3(c, c)
        self.conv2 = conv3x3(c, 3)
        self.conv3 = conv3x3(3, c)

    def forward(self, x, x_img):
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class HINetModule(nn.Module):
    def __init__(self, num_channels: int = 64, depth: int = 5, relu_slope: float = 0.2,
                 in_pos_left: int = 0, in_pos_right: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = num_channels
        self.depth = depth
        self.conv_01 = conv3x3(3, c)
        self.conv_02 = conv3x3(3, c)
        self.down_path_1, self.down_path_2 = nn.ModuleList(), nn.ModuleList()
        prev = c
        for i in range(depth):
            use_hin = in_pos_left <= i <= in_pos_right
            down = (i + 1) < depth
            self.down_path_1.append(HINConvBlock(prev, 2 ** i * c, down, relu_slope,
                                                 use_hin=use_hin))
            self.down_path_2.append(HINConvBlock(prev, 2 ** i * c, down, relu_slope,
                                                 use_csff=down, use_hin=use_hin))
            prev = 2 ** i * c
        self.up_path_1, self.up_path_2 = nn.ModuleList(), nn.ModuleList()
        self.skip_conv_1, self.skip_conv_2 = nn.ModuleList(), nn.ModuleList()
        for i in reversed(range(depth - 1)):
            self.up_path_1.append(HINUpBlock(prev, 2 ** i * c, relu_slope))
            self.up_path_2.append(HINUpBlock(prev, 2 ** i * c, relu_slope))
            self.skip_conv_1.append(conv3x3(2 ** i * c, 2 ** i * c))
            self.skip_conv_2.append(conv3x3(2 ** i * c, 2 ** i * c))
            prev = 2 ** i * c
        self.sam12 = SAM(prev)
        self.cat12 = nn.Conv2d(2 * prev, prev, 1)
        self.last = conv3x3(prev, 3)
        # flax's defaults: lecun normal kernels (the transposed conv's fan-in
        # is its output channels x 2 x 2 in both layouts), zero biases
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, image: torch.Tensor) -> dict:
        x = image.permute(0, 3, 1, 2)
        x1 = self.conv_01(x)
        encs, decs = [], []
        for blk in self.down_path_1:
            if blk.downsample is not None:
                x1, x1_up = blk(x1)
                encs.append(x1_up)
            else:
                x1 = blk(x1)
        for i, (up, skip) in enumerate(zip(self.up_path_1, self.skip_conv_1)):
            x1 = up(x1, skip(encs[-i - 1]))
            decs.append(x1)
        sam_feats, y1 = self.sam12(x1, x)

        x2 = self.cat12(torch.cat([self.conv_02(x), sam_feats], dim=1))
        blocks = []
        for i, blk in enumerate(self.down_path_2):
            if blk.downsample is not None:
                x2, x2_up = blk(x2, encs[i], decs[-i - 1])
                blocks.append(x2_up)
            else:
                x2 = blk(x2)
        for i, (up, skip) in enumerate(zip(self.up_path_2, self.skip_conv_2)):
            x2 = up(x2, skip(blocks[-i - 1]))
        y2 = self.last(x2) + x
        return {"stage1": y1.permute(0, 2, 3, 1), "enhanced": y2.permute(0, 2, 3, 1)}


def _hinet_loss():
    """psnr_loss of ``enhanced`` and of ``stage1`` against ``ref_image``, summed."""
    psnr_l = psnr_loss()

    def fn(outputs, datapoint):
        target = datapoint["ref_image"]
        return psnr_l(outputs["enhanced"], target) + psnr_l(outputs["stage1"], target)
    return fn


@MODELS.register(name="hinet_re", arch="hinet", aliases=["hinet"],
                 tasks=(Task.DEBLUR, Task.DENOISE, Task.DERAIN, Task.DESNOW, Task.LES),
                 schemes=(Scheme.SUPERVISED,))
def hinet_re(num_channels: int = 64, depth: int = 5, relu_slope: float = 0.2,
             in_pos_left: int = 0, in_pos_right: int = 4,
             generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="hinet_re", arch="hinet",
        module=HINetModule(num_channels=num_channels, depth=depth, relu_slope=relu_slope,
                           in_pos_left=in_pos_left, in_pos_right=in_pos_right,
                           generator=generator),
        tasks=(Task.DEBLUR, Task.DENOISE, Task.DERAIN, Task.DESNOW, Task.LES),
        schemes=(Scheme.SUPERVISED,),
        required_inputs=("image",),
        size_divisor=16,
        loss_fn=_hinet_loss(),
    )
