"""SGZ: semantic-guided zero-shot low-light enhancement.

Port of ``enhax/models/llie/sgz.py``: a Zero-DCE++-style curve net of 7
depthwise-separable convs (32 features) estimates one shared 3-channel
curve at 1/``scale_factor`` of the image (the half-pixel bilinear
``resize`` down, no antialias), upsamples it with **corner-aligned**
bilinear (``resize_align_corners``, the reference's
``nn.UpsamplingBilinear2d``), and applies it ``num_iters`` (8) times at
full resolution.

Where autograd records the forward (a training step) the curve loop is the
differentiable ``apply_curves``; otherwise (``no_grad``,
``inference_mode``, ``Predictor``, validation) it is the port's
``fused_curve_apply`` in its shared form, one launch a forward on a CUDA
tensor. The half-pixel ``fused_curve_upsample_apply`` is not used: its
upsample is another function.

The loss (``sgz_loss``) is the reference's four zero-reference terms,
1600 TV(curve) + spa8 + 5 col + 10 exp(16, 0.6); the semantic-segmentation
term, which needs the reference's pretrained segmentation net, is left out
as in the JAX package. Parameter names are the reference's:
``e_convN.depth_conv`` and ``e_convN.point_conv``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.kernels import apply_curves, fused_curve_apply
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d
from enhax_torch.nn.losses import (color_constancy_loss, exposure_control_loss,
                                   spatial_consistency_loss, total_variation_loss)
from enhax_torch.ops.resize import resize, resize_align_corners


class CSDNTem(nn.Module):
    """Depthwise 3x3 then pointwise 1x1, both biased (the reference's
    ``CSDN_Tem``; the JAX package's ``DSConv``)."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.depth_conv = flax_conv2d(in_channels, in_channels, 3, groups=in_channels,
                                      generator=generator)
        self.point_conv = flax_conv2d(in_channels, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_conv(self.depth_conv(x))


class SGZModule(nn.Module):
    def __init__(self, num_channels: int = 32, num_iters: int = 8, scale_factor: int = 12,
                 generator: torch.Generator | None = None):
        super().__init__()
        nf, g = num_channels, generator
        self.num_iters = num_iters
        self.scale_factor = scale_factor
        self.e_conv1 = CSDNTem(3, nf, g)
        self.e_conv2 = CSDNTem(nf, nf, g)
        self.e_conv3 = CSDNTem(nf, nf, g)
        self.e_conv4 = CSDNTem(nf, nf, g)
        self.e_conv5 = CSDNTem(2 * nf, nf, g)
        self.e_conv6 = CSDNTem(2 * nf, nf, g)
        self.e_conv7 = CSDNTem(2 * nf, 3, g)

    def forward(self, x: torch.Tensor) -> dict:
        sf = self.scale_factor
        h, w = x.shape[-3], x.shape[-2]
        x_down = x
        if sf != 1:
            x_down = resize(x, (int(h // sf * sf) // sf, int(w // sf * sf) // sf),
                            method="bilinear")
        r = torch.relu
        x1 = r(self.e_conv1(x_down.permute(0, 3, 1, 2)))
        x2 = r(self.e_conv2(x1))
        x3 = r(self.e_conv3(x2))
        x4 = r(self.e_conv4(x3))
        x5 = r(self.e_conv5(torch.cat([x3, x4], 1)))
        x6 = r(self.e_conv6(torch.cat([x2, x5], 1)))
        x_r = torch.tanh(self.e_conv7(torch.cat([x1, x6], 1))).permute(0, 2, 3, 1)
        if sf != 1:
            x_r = resize_align_corners(x_r, (h, w))
        x_r = x_r.contiguous()
        # the kernel has no backward: a forward that autograd records takes
        # the differentiable loop, as the JAX package trains
        if torch.is_grad_enabled() and (x.requires_grad or x_r.requires_grad):
            y = apply_curves(x, x_r, self.num_iters, shared=True)
        else:
            y = fused_curve_apply(x.contiguous(), x_r, self.num_iters, shared=True)
        return {"enhanced": y, "adjust": x_r}


def sgz_loss(exp_mean_val: float = 0.6):
    """SGZ's zero-reference terms (the segmentation guidance left out)."""
    spa8 = spatial_consistency_loss(num_regions=8)
    exp = exposure_control_loss(patch_size=16, mean_val=exp_mean_val)
    col = color_constancy_loss()
    tva = total_variation_loss()

    def fn(outputs, datapoint):
        enhanced = outputs["enhanced"]
        return (1600.0 * tva(outputs["adjust"]) + spa8(enhanced, datapoint["image"])
                + 5.0 * col(enhanced) + 10.0 * exp(enhanced))
    return fn


@MODELS.register(name="sgz", arch="zero_dce", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def sgz(num_channels: int = 32, num_iters: int = 8, scale_factor: int = 12,
        generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="sgz", arch="zero_dce",
        module=SGZModule(num_channels=num_channels, num_iters=num_iters,
                         scale_factor=scale_factor, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        loss_fn=sgz_loss(),
        required_inputs=("image",),
        size_divisor=max(int(scale_factor), 1),
    )
