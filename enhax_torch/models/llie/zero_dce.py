"""Zero-DCE family: zero-reference deep curve estimation for LLIE.

Port of ``enhax/models/llie/zero_dce.py``:
  * ``zero_dce_re``: 7x Conv2d U-skip curve estimator, 8 per-iteration
    curves.
  * ``zero_dce++_re``: depthwise-separable convs, one shared curve applied
    num_iters times, optional low-resolution estimation (``scale_factor``).
  * ``zero_dce_v``: curves on the HSV value channel at ``down_size``,
    applied there, the result upsampled by a fast guided filter into V; an
    instance model (``instance_steps`` Adam steps an image, ``Predictor``).

Images are NHWC at the module boundary. ``DCENet`` runs NCHW inside (on an
NHWC tensor that is channels_last in memory); its curve goes back to
NHWC-contiguous before the curve kernels. The parameter names are the
reference torch code's (``e_convN``), so released checkpoints load with
``load_state_dict`` as they are.

Where autograd records the forward (a training step: grad enabled and the
image or the curves require grad), the curves are applied by the
differentiable ``apply_curves``, as the JAX package trains; otherwise
(``no_grad``, ``inference_mode``, ``Predictor``, validation) by the curve
kernels. The loss of all three is ``zero_reference_loss``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.kernels import (apply_curves, fused_curve_apply,
                                 fused_curve_upsample_apply)
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import DSConv, conv3x3, lecun_normal_
from enhax_torch.nn.losses import (color_constancy_loss, exposure_control_loss,
                                   spatial_consistency_loss, total_variation_loss)
from enhax_torch.ops.color import hsv_to_rgb, rgb_to_hsv
from enhax_torch.ops.filtering import fast_guided_filter_bicubic
from enhax_torch.ops.resize import resize, resize_nearest_torch

__all__ = ["DCENet", "ZeroDCE", "ZeroDCEV", "apply_curves", "dce_init_",
           "zero_reference_loss"]


@torch.no_grad()
def dce_init_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Conv init N(0, 0.02)."""
    return weight.normal_(0.0, 0.02, generator=generator)


class DCENet(nn.Module):
    """7-conv U-skip curve estimation network on NCHW tensors."""

    def __init__(self, in_channels: int = 3, num_channels: int = 32,
                 out_channels: int = 24, conv_type: str = "conv",
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv_type not in ("conv", "dsconv"):
            raise ValueError(f"conv_type must be 'conv' or 'dsconv', got {conv_type!r}")
        conv = conv3x3 if conv_type == "conv" else DSConv
        nc = num_channels
        self.e_conv1 = conv(in_channels, nc)
        self.e_conv2 = conv(nc, nc)
        self.e_conv3 = conv(nc, nc)
        self.e_conv4 = conv(nc, nc)
        self.e_conv5 = conv(2 * nc, nc)
        self.e_conv6 = conv(2 * nc, nc)
        self.e_conv7 = conv(2 * nc, out_channels)
        # zero_dce_re draws its convs from N(0, 0.02); the DSConv halves keep
        # flax's default (lecun normal), as in the JAX package. Biases are 0.
        init = dce_init_ if conv_type == "conv" else lecun_normal_
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.relu
        x1 = r(self.e_conv1(x))
        x2 = r(self.e_conv2(x1))
        x3 = r(self.e_conv3(x2))
        x4 = r(self.e_conv4(x3))
        x5 = r(self.e_conv5(torch.cat([x3, x4], 1)))
        x6 = r(self.e_conv6(torch.cat([x2, x5], 1)))
        return torch.tanh(self.e_conv7(torch.cat([x1, x6], 1)))


class ZeroDCE(DCENet):
    """Full Zero-DCE forward on NHWC images: curves + iterative application.

    A forward that autograd records runs the differentiable curve loop, and
    so does a grad-enabled call that only serves: on the card it is far
    slower than the kernels, which serve under ``torch.no_grad()`` or
    ``torch.inference_mode()`` (as ``Predictor`` and the eval step call).
    ``ZeroDCE.curve_loop_forwards`` counts the forwards that took the loop."""

    curve_loop_forwards = 0

    def __init__(self, in_channels: int = 3, num_channels: int = 32,
                 num_iters: int = 8, conv_type: str = "conv",
                 shared_curve: bool = False, scale_factor: float = 1.0,
                 generator: torch.Generator | None = None):
        out_ch = in_channels if shared_curve else in_channels * num_iters
        super().__init__(in_channels, num_channels, out_ch, conv_type, generator)
        self.num_iters = num_iters
        self.shared_curve = shared_curve
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> dict:
        sf = self.scale_factor
        x_down = x
        if sf != 1.0:
            h = int(x.shape[-3] / sf)
            w = int(x.shape[-2] / sf)
            x_down = resize(x, (h, w), method="bilinear")
        curves_lr = super().forward(x_down.permute(0, 3, 1, 2))
        curves_lr = curves_lr.permute(0, 2, 3, 1).contiguous()
        curves = curves_lr
        if sf != 1.0:
            curves = resize(curves_lr, (x.shape[-3], x.shape[-2]),
                            method="bilinear")
        # A forward that autograd records (training) takes the differentiable
        # curve loop, the JAX package's own training path: the kernels have
        # no backward and refuse such a call.
        if torch.is_grad_enabled() and (x.requires_grad or curves.requires_grad):
            ZeroDCE.curve_loop_forwards += 1
            y = apply_curves(x, curves, self.num_iters, self.shared_curve)
            return {"adjust": curves, "enhanced": y}
        # With a downscaled shared curve at an integer ratio, the kernel
        # interpolates the curve itself, so its full-resolution copy is only
        # the "adjust" output (which the JAX package returns as well).
        fused_up_ok = (self.shared_curve and sf == float(int(sf)) and sf > 1
                       and x.shape[-3] % int(sf) == 0
                       and x.shape[-2] % int(sf) == 0)
        x = x.contiguous()
        if fused_up_ok:
            y = fused_curve_upsample_apply(x, curves_lr, self.num_iters, int(sf))
        else:
            y = fused_curve_apply(x, curves.contiguous(), self.num_iters,
                                  self.shared_curve)
        return {"adjust": curves, "enhanced": y}


class ZeroDCEV(DCENet):
    """Zero-DCE-V on NHWC images: 15 per-iteration curves estimated from the
    HSV value channel resized (nearest) to ``down_size``, applied there,
    upsampled into V by a bicubic fast guided filter; RGB divided by its
    maximum over the whole batch. The curves go through ``apply_curves``
    where autograd records the forward, through ``fused_curve_apply`` at
    (B, down_size, down_size, 1) otherwise, as ``ZeroDCE``'s (the loop's
    forwards counted in ``ZeroDCE.curve_loop_forwards``)."""

    def __init__(self, num_channels: int = 32, num_iters: int = 15, down_size: int = 256,
                 radius: int = 1, eps: float = 1e-8,
                 generator: torch.Generator | None = None):
        super().__init__(1, num_channels, num_iters, "conv", generator)
        self.num_iters = num_iters
        self.down_size = down_size
        self.radius = radius
        self.eps = eps

    def forward(self, x: torch.Tensor) -> dict:
        hsv = rgb_to_hsv(x)
        v = hsv[..., 2:3]
        v_lr = resize_nearest_torch(v, (self.down_size, self.down_size)).contiguous()
        curves = super().forward(v_lr.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        if torch.is_grad_enabled() and (v_lr.requires_grad or curves.requires_grad):
            ZeroDCE.curve_loop_forwards += 1
            v_fixed_lr = apply_curves(v_lr, curves, self.num_iters, False)
        else:
            v_fixed_lr = fused_curve_apply(v_lr, curves, self.num_iters, False)
        v_fixed = fast_guided_filter_bicubic(v_lr, v_fixed_lr, v, radius=self.radius,
                                             eps=self.eps).clamp(0.0, 1.0)
        rgb = hsv_to_rgb(torch.cat([hsv[..., :2], v_fixed], dim=-1))
        rgb = rgb / rgb.max().clamp_min(1e-8)
        return {"adjust": curves, "enhanced": rgb, "image_v": v, "image_v_fixed": v_fixed}


def zero_reference_loss(spa_weight: float = 1.0, exp_patch_size: int = 16,
                        exp_mean_val: float = 0.6, exp_weight: float = 10.0,
                        col_weight: float = 5.0, tva_weight: float = 200.0,
                        enhanced_key: str = "enhanced", adjust_key: str = "adjust"):
    """Zero-DCE's four-term loss: spatial consistency of ``enhanced``
    against ``image``, exposure control and colour constancy of
    ``enhanced``, total variation of the full-resolution curve ``adjust``."""
    spa = spatial_consistency_loss()
    exp = exposure_control_loss(patch_size=exp_patch_size, mean_val=exp_mean_val)
    col = color_constancy_loss()
    tva = total_variation_loss()

    def fn(outputs, datapoint):
        enhanced = outputs[enhanced_key]
        return (spa_weight * spa(enhanced, datapoint["image"])
                + exp_weight * exp(enhanced)
                + col_weight * col(enhanced)
                + tva_weight * tva(outputs[adjust_key]))
    return fn


@MODELS.register(name="zero_dce_re", arch="zero_dce", aliases=["zero_dce"],
                 tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def zero_dce_re(in_channels: int = 3, num_channels: int = 32, num_iters: int = 8,
                generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="zero_dce_re", arch="zero_dce",
        module=ZeroDCE(in_channels=in_channels, num_channels=num_channels,
                       num_iters=num_iters, conv_type="conv",
                       generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        required_inputs=("image",),
        loss_fn=zero_reference_loss(),
    )


@MODELS.register(name="zero_dce++_re", arch="zero_dce",
                 aliases=["zero_dcepp_re", "zero_dce++", "zero_dcepp"],
                 tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def zero_dcepp_re(in_channels: int = 3, num_channels: int = 32, num_iters: int = 8,
                  scale_factor: float = 1.0, generator: torch.Generator | None = None,
                  **kwargs) -> Model:
    return Model(
        name="zero_dce++_re", arch="zero_dce",
        module=ZeroDCE(in_channels=in_channels, num_channels=num_channels,
                       num_iters=num_iters, conv_type="dsconv",
                       shared_curve=True, scale_factor=scale_factor,
                       generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        required_inputs=("image",),
        loss_fn=zero_reference_loss(),
    )


@MODELS.register(name="zero_dce_v", arch="zero_dce", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE, Scheme.INSTANCE))
def zero_dce_v(num_channels: int = 32, num_iters: int = 15, down_size: int = 256,
               generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="zero_dce_v", arch="zero_dce",
        module=ZeroDCEV(num_channels=num_channels, num_iters=num_iters,
                        down_size=down_size, generator=generator),
        tasks=(Task.LLIE,),
        schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE, Scheme.INSTANCE),
        required_inputs=("image",),
        loss_fn=zero_reference_loss(exp_mean_val=0.8),
        instance_steps=100, instance_lr=1e-4,
    )
