"""NeurOP: neural colour operators for image retouching.

Port of ``enhax/models/retouch/neurop.py``:
  * ``Operator``: 1x1 encoder -> code + a scalar strength -> 1x1 mid conv
    + LeakyReLU(0.01) -> 1x1 decoder;
  * ``StrengthEncoder``: 7x7/2 and 3x3/2 convs (padding 1) with ReLU, then
    [std (unbiased), mean, max] over H and W;
  * ``neurop_re``: the operators in the renderer's order bc -> ex -> vb;
    before each, the current image resized to 256 x 256*W/H (bilinear,
    half-pixel, no antialias) is encoded and a tanh strength predicted; one
    clamp at the end. Loss: L1 + 0.1 (cosine + total variation);
  * ``neurop_init``: the operators' pretraining on ``image_{ex,bc,vb}``
    and ``val_{ex,bc,vb}`` datapoints (each reconstructs its input at
    strength 0 and maps it to ``ref_*`` at the given strength; L1 over the
    six pairs).
As in the JAX package, both start from their init (no renderer
checkpoint) and both registrations take and ignore other keywords
(``pixel_weight`` of ``configs/neurop_re_*.py``). The module holds NCHW
maps; in and out NHWC. Parameter names are the reference's
(``image_encoder``, ``{k}_renderer``, ``{k}_predictor.fc3``,
``renderer.{k}_block``), so a released ``.pth`` loads as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import dense
from enhax_torch.nn.layers import flax_conv2d

_OPS = ("ex", "bc", "vb")


class Operator(nn.Module):
    def __init__(self, base_nf: int = 64, generator=None):
        super().__init__()
        g = generator
        self.encoder = flax_conv2d(3, base_nf, 1, generator=g)
        self.mid_conv = flax_conv2d(base_nf, base_nf, 1, generator=g)
        self.decoder = flax_conv2d(base_nf, 3, 1, generator=g)

    def forward(self, x: torch.Tensor, val) -> torch.Tensor:
        code = self.encoder(x) + val
        return self.decoder(F.leaky_relu(self.mid_conv(code), 0.01))


class StrengthEncoder(nn.Module):
    def __init__(self, encode_nf: int = 32, generator=None):
        super().__init__()
        g = generator
        self.conv1 = flax_conv2d(3, encode_nf, 7, stride=2, padding=1, generator=g)
        self.conv2 = flax_conv2d(encode_nf, encode_nf, 3, stride=2, padding=1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv2(F.relu(self.conv1(x))))
        return torch.cat([y.std(dim=(-2, -1)), y.mean(dim=(-2, -1)), y.amax(dim=(-2, -1))], 1)


class _Predictor(nn.Module):
    """The reference's ``{k}_predictor``: its ``fc3``, features -> 1."""

    def __init__(self, features: int, generator=None):
        super().__init__()
        self.fc3 = dense(features, 1, generator=generator)


class NeurOPModule(nn.Module):
    """NHWC image -> {"enhanced", "val_bc", "val_ex", "val_vb"}."""

    def __init__(self, base_nf: int = 64, encode_nf: int = 32, generator=None):
        super().__init__()
        for k in _OPS:
            setattr(self, f"{k}_renderer", Operator(base_nf, generator))
        self.image_encoder = StrengthEncoder(encode_nf, generator)
        for k in _OPS:
            setattr(self, f"{k}_predictor", _Predictor(3 * encode_nf, generator))

    def forward(self, x: torch.Tensor) -> dict:
        y = x.permute(0, 3, 1, 2)
        h, w = y.shape[-2:]
        rh, rw = 256, int(256 * w / h)
        out = {}
        for k in ("bc", "ex", "vb"):   # the renderer's order
            resized = F.interpolate(y, size=(rh, rw), mode="bilinear", align_corners=False,
                                    antialias=False)
            val = torch.tanh(getattr(self, f"{k}_predictor").fc3(self.image_encoder(resized)))
            out[f"val_{k}"] = val
            y = getattr(self, f"{k}_renderer")(y, val[:, :, None, None])
        return {"enhanced": y.clamp(0, 1).permute(0, 2, 3, 1), **out}


class _Renderer(nn.Module):
    """The reference's ``renderer``: the three operators."""

    def __init__(self, base_nf: int, generator=None):
        super().__init__()
        for k in _OPS:
            setattr(self, f"{k}_block", Operator(base_nf, generator))


class NeurOPInitModule(nn.Module):
    """(x_ex, x_bc, x_vb, v_ex, v_bc, v_vb) -> {"rec_image_k", "map_ref_k"}."""

    def __init__(self, base_nf: int = 64, generator=None):
        super().__init__()
        self.renderer = _Renderer(base_nf, generator)

    def forward(self, x_ex, x_bc, x_vb, v_ex, v_bc, v_vb) -> dict:
        out = {}
        for k, x, v in (("ex", x_ex, v_ex), ("bc", x_bc, v_bc), ("vb", x_vb, v_vb)):
            op = getattr(self.renderer, f"{k}_block")
            xc = x.permute(0, 3, 1, 2)
            v = torch.as_tensor(v, dtype=xc.dtype, device=xc.device).reshape(-1, 1, 1, 1)
            out[f"rec_image_{k}"] = op(xc, 0.0).permute(0, 2, 3, 1)
            out[f"map_ref_{k}"] = op(xc, v).permute(0, 2, 3, 1)
        return out


def _neurop_loss():
    l1, tv = LOSSES.build("l1_loss"), LOSSES.build("total_variation_loss")

    def cos_loss(a, b):
        af, bf = a.reshape(a.shape[0], -1, 3), b.reshape(b.shape[0], -1, 3)
        den = (af.norm(dim=-1) * bf.norm(dim=-1)).clamp_min(1e-8)
        return 1.0 - ((af * bf).sum(-1) / den).mean()

    def fn(outputs, datapoint):
        p, t = outputs["enhanced"], datapoint["ref_image"]
        return l1(p, t) + 0.1 * (cos_loss(p, t) + tv(p))
    return fn


@MODELS.register(name="neurop_re", arch="neurop", aliases=["neurop"],
                 tasks=(Task.RETOUCH, Task.LLIE), schemes=(Scheme.SUPERVISED,))
def neurop_re(base_nf: int = 64, encode_nf: int = 32, generator: torch.Generator | None = None,
              **kwargs) -> Model:
    return Model(name="neurop_re", arch="neurop",
                 module=NeurOPModule(base_nf, encode_nf, generator),
                 tasks=(Task.RETOUCH, Task.LLIE), schemes=(Scheme.SUPERVISED,),
                 loss_fn=_neurop_loss(), required_inputs=("image",), size_divisor=4)


@MODELS.register(name="neurop_init", arch="neurop", tasks=(Task.RETOUCH,),
                 schemes=(Scheme.SUPERVISED,))
def neurop_init(base_nf: int = 64, generator: torch.Generator | None = None,
                **kwargs) -> Model:
    l1 = LOSSES.build("l1_loss")

    def loss_fn(outputs, dp):
        loss = 0.0
        for k in _OPS:
            loss = loss + l1(outputs[f"rec_image_{k}"], dp[f"image_{k}"])
            loss = loss + l1(outputs[f"map_ref_{k}"], dp[f"ref_{k}"])
        return loss

    return Model(name="neurop_init", arch="neurop",
                 module=NeurOPInitModule(base_nf, generator), tasks=(Task.RETOUCH,),
                 schemes=(Scheme.SUPERVISED,), loss_fn=loss_fn,
                 required_inputs=("image_ex", "image_bc", "image_vb",
                                  "val_ex", "val_bc", "val_vb"))
