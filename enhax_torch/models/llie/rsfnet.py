"""RSFNet: Retinex sparse-factorization network, an instance model.

Port of ``enhax/models/llie/rsfnet.py``:

  * the factorization: per factor f an unrolled loop of ``num_iters``
    steps with scalar parameters ``lambda_a``, ``lambda_e`` (zeros) and
    ``step`` (ones) a (factor, step): the pixel-group shrinkage ``thres_e``
    (each pixel's channel norm), the global shrinkage ``thres_a`` (the
    square root of the sum of the channel norms over the image), the dual
    variable from x / ||x||_2, where the norm is over the **whole** tensor,
    batch included, as in the JAX package. The factors are ReLU'd; each
    after the first is replaced by |e_f - e_(f-1)|.
  * the fusion: 4 encoder convs with ``e_conv3`` applied twice (the
    reference's quirk; its dead ``e_conv4`` is not built), a 3-conv skip
    decoder and tanh curves, then the image iterated 5 times through each
    factor's curve (x += r (x^2 - x)), in plain tensor ops as the JAX
    package computes it.
  * ``rsfnet_loss``: 10 colour constancy + 2 exposure + 2 TV.

Served through ``Predictor``'s instance route: 500 Adam steps of lr 1e-3 a
request. A channel norm's gradient at a zero vector is 0 here (torch's
``vector_norm`` backward) and NaN in the JAX package (``jnp.linalg.norm``);
the first step reaches one at every input (``thres_a`` of x - e, where e =
x at the initial thresholds), so the JAX package's fit is NaN from its
first step and the port's is not (``ROADMAP.md`` section 3).

Parameter names are the reference's: ``lambda_a.{f}.{t}``,
``lambda_e.{f}.{t}``, ``step.{f}.{t}``, ``e_conv{1,2,3}``,
``d_conv{5,6,7}``. Images are NHWC; the convs run NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import flax_conv2d
from enhax_torch.nn.losses import (color_constancy_loss, exposure_control_loss,
                                   total_variation_loss)

_EPS = float(torch.finfo(torch.float32).eps)


def _thres_e(v: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Each pixel's channel vector shrunk by ``thr`` (NHWC)."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.clamp_min(1.0 - thr / (norm + _EPS), 0.0) * v


def _thres_a(v: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Each image shrunk by ``thr`` against the square root of the sum of
    its channel norms (NHWC)."""
    norm = torch.linalg.vector_norm(v, dim=-1)
    nn_ = torch.sqrt(norm.sum((1, 2)) + _EPS)
    return torch.clamp_min(1.0 - thr / (nn_ + _EPS), 0.0)[:, None, None, None] * v


def _scalars(factors: int, num_iters: int, value: float) -> nn.ModuleList:
    return nn.ModuleList(nn.ParameterList(nn.Parameter(torch.tensor(value))
                                          for _ in range(num_iters)) for _ in range(factors))


class RSFNetModule(nn.Module):
    """The factorization's scalars and the fusion's convs side by side, as
    the reference holds them."""

    def __init__(self, factors: int = 5, num_iters: int = 3, generator=None):
        super().__init__()
        nf, g = 3, generator
        self.factors, self.num_iters = factors, num_iters
        self.lambda_a = _scalars(factors, num_iters, 0.0)
        self.lambda_e = _scalars(factors, num_iters, 0.0)
        self.step = _scalars(factors, num_iters, 1.0)
        cin = 3 * (factors + 1)
        self.e_conv1 = flax_conv2d(cin, nf, 3, generator=g)
        self.e_conv2 = flax_conv2d(nf, nf, 3, generator=g)
        self.e_conv3 = flax_conv2d(nf, nf, 3, generator=g)
        self.d_conv5 = flax_conv2d(2 * nf, nf, 3, generator=g)
        self.d_conv6 = flax_conv2d(2 * nf, nf, 3, generator=g)
        self.d_conv7 = flax_conv2d(2 * nf, cin, 3, generator=g)

    def factorize(self, x: torch.Tensor) -> torch.Tensor:
        la, le, st = self.lambda_a, self.lambda_e, self.step
        a = x
        all_e = []
        for f in range(self.factors):
            xx = a
            x_2 = torch.linalg.vector_norm(xx.reshape(-1))
            e_t = _thres_e(xx, le[f][0] / st[f][0])
            a_t = _thres_a(xx - e_t, la[f][0] / st[f][0])
            y_t = xx / (x_2 + _EPS)
            for t in range(1, self.num_iters):
                e_t = _thres_e(xx - a_t - y_t / st[f][t], le[f][t] / st[f][t])
                a_t = _thres_a(xx - e_t - y_t / st[f][t], la[f][t] / st[f][t])
                y_t = y_t + st[f][t] * (e_t + a_t - xx)
            e_t = torch.relu(e_t)
            a = a - e_t
            if f > 0:
                e_t = (e_t - all_e[-1]).abs()
            all_e.append(e_t)
        return torch.cat(all_e, -1)

    def fuse(self, s: torch.Tensor) -> torch.Tensor:
        r = torch.relu
        e1 = r(self.e_conv1(s))
        e2 = r(self.e_conv2(e1))
        e3 = r(self.e_conv3(e2))
        e4 = r(self.e_conv3(e3))        # the reference applies e_conv3 twice
        d1 = r(self.d_conv5(torch.cat([e3, e4], 1)))
        d2 = r(self.d_conv6(torch.cat([e2, d1], 1)))
        rs = torch.tanh(self.d_conv7(torch.cat([e1, d2], 1))).split(3, dim=1)
        x = s[:, :3]
        for _ in range(5):
            for rj in rs:
                x = x + rj * (x ** 2 - x)
        return x

    def forward(self, x: torch.Tensor) -> dict:
        s = self.factorize(x)
        full = torch.cat([x, s], -1).permute(0, 3, 1, 2)
        return {"factors": s, "enhanced": self.fuse(full).permute(0, 2, 3, 1)}


def rsfnet_loss(col_weight: float = 10.0, exp_weight: float = 2.0, tv_weight: float = 2.0):
    col = color_constancy_loss()
    tv = total_variation_loss()
    exp = exposure_control_loss(patch_size=16, mean_val=0.6)

    def fn(outputs, datapoint):
        e = outputs["enhanced"]
        return col_weight * col(e) + exp_weight * exp(e) + tv_weight * tv(e)
    return fn


@MODELS.register(name="rsfnet", arch="rsfnet", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_REFERENCE, Scheme.INSTANCE))
def rsfnet(factors: int = 5, num_iters: int = 3, generator: torch.Generator | None = None,
           **kwargs) -> Model:
    return Model(
        name="rsfnet", arch="rsfnet",
        module=RSFNetModule(factors=factors, num_iters=num_iters, generator=generator),
        tasks=(Task.LLIE,), schemes=(Scheme.ZERO_REFERENCE, Scheme.INSTANCE),
        loss_fn=rsfnet_loss(),
        required_inputs=("image",),
        instance_steps=500, instance_lr=1e-3,
    )
