"""PSENet: a pseudo-supervised exposure-correction network.

Port of ``enhax/models/llie/psenet.py``: a UNet of MobileNetV3 bottlenecks
(``UnetTMO``) predicts a per-pixel exponent r, enhanced = 1 - (1 - x)^r; it
trains against a pseudo ground truth, the per-pixel best of the input, the
network's own (detached) output and random gamma curves of the input under
``good_looking_score``. As in the JAX package, the current batch's detached
output is the "previous" candidate (the reference's one-batch delay is a
training-loop artifact).

The gammas are drawn from a ``torch.Generator`` the model owns (seeded by
the ``generator`` the model is built with, after the weights), where the JAX package
draws from the step's key; ``pseudo_gt(..., rand01=u)`` replaces the draws
by ``u``, as the JAX function's ``rand01`` does. The module holds NCHW
maps; in and out NHWC. Parameter names are the reference's
(``model.first_conv.conv.0`` the expand 1x1, ``.conv.2`` the depthwise,
``.conv.3.fc.0``/``fc.2`` the SE, ``.conv.5`` the projection), so a
released ``.pth`` loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d


class SEModule(nn.Module):
    """Global mean -> 1x1 -> ReLU -> 1x1, multiplied in (no sigmoid)."""

    def __init__(self, channels: int, reduction: int = 1, generator=None):
        super().__init__()
        mid = channels // reduction
        self.fc = nn.Sequential(flax_conv2d(channels, mid, 1, generator=generator), nn.ReLU(),
                                flax_conv2d(mid, channels, 1, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(-2, -1), keepdim=True))


class MobileBottleneck(nn.Module):
    """Expand 1x1 -> LeakyReLU(0.01) -> reflect-padded depthwise -> (SE) ->
    LeakyReLU -> project 1x1, all biased; residual at stride 1 where the
    widths agree."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 expand: int = 6, use_se: bool = False, generator=None):
        super().__init__()
        g = generator
        self.residual = stride == 1 and in_channels == features
        dw = flax_conv2d(expand, expand, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=expand, generator=g)
        dw.padding_mode = "reflect"
        self.conv = nn.Sequential(
            flax_conv2d(in_channels, expand, 1, generator=g), nn.LeakyReLU(0.01), dw,
            SEModule(expand, generator=g) if use_se else nn.Identity(), nn.LeakyReLU(0.01),
            flax_conv2d(expand, features, 1, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + x if self.residual else y


def _resize_ac(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class UnetTMO(nn.Module):
    def __init__(self, base_number: int = 16, generator=None):
        super().__init__()
        b, g = base_number, generator
        mb = MobileBottleneck
        self.first_conv = mb(3, 3, expand=6, use_se=True, generator=g)
        self.conv1 = mb(3, b, stride=2, expand=int(b * 1.5), generator=g)
        self.conv2 = mb(b, b, expand=int(b * 1.5), generator=g)
        self.conv3 = mb(b, b * 2, stride=2, expand=b * 3, generator=g)
        self.conv5 = mb(b * 2, b * 2, expand=b * 3, generator=g)
        self.conv6 = mb(b * 2, b, expand=b * 3, generator=g)
        self.conv7 = mb(2 * b, b, expand=b * 3, generator=g)
        self.conv8 = mb(b, 3, expand=int(b * 1.5), generator=g)
        self.last_conv = mb(6, 3, expand=9, use_se=True, generator=g)

    def forward(self, x: torch.Tensor) -> tuple:
        x1 = self.first_conv(x)
        r = self.conv2(self.conv1(x1))
        r_d2 = r
        r = self.conv6(self.conv5(self.conv3(r)))
        r = _resize_ac(r, r_d2.shape[-2:])
        r = self.conv8(self.conv7(torch.cat([r_d2, r], 1)))
        r = _resize_ac(r, x.shape[-2:])
        r = self.last_conv(torch.cat([x1, r], 1))
        r = (r + 1.0).abs()
        return 1.0 - torch.pow((1.0 - x).clamp(1e-6, 1.0), r), r


class PSENetModule(nn.Module):
    """NHWC image -> {"enhanced", "adjust"} (the reference's ``model``)."""

    def __init__(self, base_number: int = 16, generator=None):
        super().__init__()
        self.model = UnetTMO(base_number, generator)

    def forward(self, x: torch.Tensor) -> dict:
        y, r = self.model(x.permute(0, 3, 1, 2))
        return {"enhanced": y.permute(0, 2, 3, 1), "adjust": r.permute(0, 2, 3, 1)}


def good_looking_score(images: torch.Tensor, exposed_level: float = 0.5,
                       pool_size: int = 25) -> torch.Tensor:
    """Per-pixel score of (..., H, W, 3) images -> (..., H, W, 1): high
    saturation and local contrast (25x25 reflect-padded means), low distance
    from the target exposure."""
    eps = 1.0 / 255.0
    p = pool_size // 2
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]

    def mean_pool(x):
        xc = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        xc = F.avg_pool2d(F.pad(xc, (p, p, p, p), mode="reflect"), pool_size, stride=1)
        return xc.permute(0, 2, 3, 1).reshape(*lead, h, w, c)

    max_rgb = images.amax(-1, keepdim=True)
    min_rgb = images.amin(-1, keepdim=True)
    saturation = (max_rgb - min_rgb + eps) / (max_rgb + eps)
    mean_rgb = mean_pool(images).mean(-1, keepdim=True)
    exposedness = (mean_rgb - exposed_level).abs() + eps
    contrast = mean_pool(images * images).mean(-1, keepdim=True) - mean_rgb ** 2
    return (saturation * contrast) / exposedness


def pseudo_gt(image: torch.Tensor, generator: torch.Generator | None = None,
              prev_output: torch.Tensor | None = None, number_refs: int = 1,
              gamma_upper: float = 3.0, gamma_lower: float = -2.0,
              exposed_level: float = 0.5, pool_size: int = 25,
              rand01: float | None = None) -> torch.Tensor:
    """The per-pixel argmax of ``good_looking_score`` over the input, the
    detached ``prev_output`` and 2N gamma curves 1 - (1 - x)^g: g = exp of
    uniform draws over the under-exposure range, and over the over-exposure
    range with the reference's multiply-by-range-start. ``rand01`` replaces
    the draws (parity tests)."""
    b = image.shape[0]
    under_ranges = torch.linspace(0.0, gamma_upper, number_refs + 1, dtype=image.dtype,
                                  device=image.device)[:-1]
    step = gamma_upper / number_refs
    if rand01 is None:
        u1 = torch.rand((b, number_refs), generator=generator).to(image)
        u2 = torch.rand((b, number_refs), generator=generator).to(image)
    else:
        u1 = u2 = torch.full((b, number_refs), rand01, dtype=image.dtype, device=image.device)
    under_g = torch.exp(u1 * step + under_ranges)
    over_ranges = torch.linspace(gamma_lower, 0.0, number_refs + 1, dtype=image.dtype,
                                 device=image.device)[:-1]
    over_g = torch.exp(u2 * over_ranges)
    gammas = torch.cat([under_g, over_g], 1)
    synth = 1.0 - torch.pow((1.0 - image[:, None]).clamp(1e-6, 1.0),
                            gammas[:, :, None, None, None])
    refs = [image[:, None]]
    if prev_output is not None:
        refs.append(prev_output.detach()[:, None])
    refs = torch.cat(refs + [synth], 1)
    idx = good_looking_score(refs, exposed_level, pool_size).argmax(1, keepdim=True)
    return torch.take_along_dim(refs, idx.expand(-1, -1, -1, -1, refs.shape[-1]), 1)[:, 0]


def _make_psenet_forward_loss(tv_weight: float = 5.0, gamma_lower: float = -2.0,
                              gamma_upper: float = 3.0, number_refs: int = 1,
                              generator: torch.Generator | None = None):
    """MSE to the pseudo ground truth plus ``tv_weight`` times the squared
    differences of log(r + 1e-3), each axis's mean."""

    def forward_loss(model: Model, datapoint: dict) -> tuple:
        image = datapoint["image"]
        out = model.apply({"image": image}, training=True)
        gt = pseudo_gt(image, generator, prev_output=out["enhanced"], number_refs=number_refs,
                       gamma_upper=gamma_upper, gamma_lower=gamma_lower).detach()
        recon = ((out["enhanced"] - gt) ** 2).mean()
        lr_ = torch.log(out["adjust"] + 1e-3)
        tv = (((lr_[:, 1:] - lr_[:, :-1]) ** 2).mean()
              + ((lr_[:, :, 1:] - lr_[:, :, :-1]) ** 2).mean())
        return recon + tv_weight * tv, out

    return forward_loss


@MODELS.register(name="psenet", arch="psenet", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED,))
def psenet(base_channels: int = 16, tv_weight: float = 5.0, gamma_lower: float = -2.0,
           gamma_upper: float = 3.0, number_refs: int = 1,
           generator: torch.Generator | None = None, **kwargs) -> Model:
    """``base_number`` is an alias of ``base_channels``, as in the JAX package."""
    base_channels = kwargs.pop("base_number", base_channels)
    module = PSENetModule(base_channels, generator)
    draws = torch.Generator().manual_seed(
        int(torch.randint(2 ** 62, (1,), generator=generator)) if generator is not None else 0)
    return Model(name="psenet", arch="psenet", module=module, tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED,),
                 forward_loss_fn=_make_psenet_forward_loss(tv_weight, gamma_lower, gamma_upper,
                                                           number_refs, draws),
                 required_inputs=("image",), size_divisor=4)
