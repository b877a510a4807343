"""GCENet: guided curve estimation with depth and edge priors.

Port of ``enhax/models/llie/gcenet.py``:
  * ``gcenet``: a DSConv U-skip curve net over [image, depth, edge], a curve
    loop weighted by the brightness attention map, a guided filter on the
    output;
  * ``gcenet_zsn2n``: adds ZSN2N's pair-downsample residual and consistency
    terms (three forwards a step, ``forward_loss_fn``);
  * ``gcenet_instance``: fitted to each image, 300 AdamW steps through
    ``Predictor``.

With ``use_depth`` the model requires ``depth`` (``required_inputs``), as
the JAX package's does. The curve loop is not the DCE curve of the curve
kernels: each step splits y by the attention map. Parameter names are the
JAX package's (``e_convN``, each a DSConv's ``dw_conv``/``pw_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.models.llie.zero_dce import zero_reference_loss
from enhax_torch.nn.layers import boundary_aware_prior, brightness_attention_map, flax_conv2d
from enhax_torch.ops.color import rgb_to_grayscale
from enhax_torch.ops.filtering import guided_filter
from enhax_torch.ops.geometry import pair_downsample


class GCEConvBlock(torch.nn.Module):
    """A DSConv (depthwise 3x3 ``dw_conv``, pointwise ``pw_conv``) then
    LeakyReLU(0.2), or tanh in the last block, on NCHW maps; flax's init
    from ``generator``."""

    def __init__(self, in_channels: int, out_channels: int, is_last: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.is_last = is_last
        self.dw_conv = flax_conv2d(in_channels, in_channels, 3, groups=in_channels,
                                   generator=generator)
        self.pw_conv = flax_conv2d(in_channels, out_channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pw_conv(self.dw_conv(x))
        return torch.tanh(x) if self.is_last else F.leaky_relu(x, 0.2)


class GCENetModule(torch.nn.Module):
    """NHWC image (and depth) -> {"adjust", "enhanced", "edge", "bam"}."""

    def __init__(self, num_channels: int = 32, num_iters: int = 15, dba_eps: float = 0.05,
                 gf_radius: int = 3, gf_eps: float = 1e-4, bam_gamma: float = 2.6,
                 bam_ksize: int = 9, use_depth: bool = True, use_edge: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_iters, self.dba_eps = num_iters, dba_eps
        self.gf_radius, self.gf_eps = gf_radius, gf_eps
        self.bam_gamma, self.bam_ksize = bam_gamma, bam_ksize
        self.use_depth, self.use_edge = use_depth, use_edge
        c, g = num_channels, generator
        self.e_conv1 = GCEConvBlock(3 + int(use_depth) + int(use_edge), c, generator=g)
        self.e_conv2 = GCEConvBlock(c, c, generator=g)
        self.e_conv3 = GCEConvBlock(c, c, generator=g)
        self.e_conv4 = GCEConvBlock(c, c, generator=g)
        self.e_conv5 = GCEConvBlock(2 * c, c, generator=g)
        self.e_conv6 = GCEConvBlock(2 * c, c, generator=g)
        self.e_conv7 = GCEConvBlock(2 * c, 3, is_last=True, generator=g)

    def forward(self, image: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        x = image
        gray = rgb_to_grayscale(image)
        if depth is not None and depth.shape[-1] == 3:
            depth = rgb_to_grayscale(depth)
        edge = None
        if self.use_depth:
            x = torch.cat([x, depth if depth is not None else gray], dim=-1)
        if self.use_edge:
            src = depth if depth is not None else gray
            edge = boundary_aware_prior(src, eps=self.dba_eps, normalized=False)
            x = torch.cat([x, edge], dim=-1)

        x = x.permute(0, 3, 1, 2)
        x1 = self.e_conv1(x)
        x2 = self.e_conv2(x1)
        x3 = self.e_conv3(x2)
        x4 = self.e_conv4(x3)
        x5 = self.e_conv5(torch.cat([x3, x4], 1))
        x6 = self.e_conv6(torch.cat([x2, x5], 1))
        adjust = self.e_conv7(torch.cat([x1, x6], 1)).permute(0, 2, 3, 1)

        y = image
        if self.bam_gamma in (None, 0.0):
            for _ in range(self.num_iters):
                y = y + adjust * (y * y - y)
            bam = None
        else:
            bam = brightness_attention_map(image, self.bam_gamma, self.bam_ksize)
            for _ in range(self.num_iters):
                bright = y * (1.0 - bam)
                dark = y * bam
                y = bright + dark + adjust * (dark * dark - dark)
        enhanced = guided_filter(y, image, radius=self.gf_radius, eps=self.gf_eps)
        return {"adjust": adjust, "enhanced": enhanced, "edge": edge, "bam": bam}


def gce_loss():
    """The zero-reference quartet on the adjust map, weight_tva 1600."""
    return zero_reference_loss(spa_weight=1.0, exp_weight=10.0, col_weight=5.0,
                               tva_weight=1600.0)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def gcenet_zsn2n_forward_loss(model: Model, datapoint: dict) -> tuple:
    """Pair-downsample residual + consistency, plus the enhancement loss."""
    image = datapoint["image"]
    has_depth = "depth" in model.required_inputs
    depth = datapoint.get("depth") if has_depth else None

    def fwd(img, dep):
        dp = {"image": img}
        if has_depth:
            dp["depth"] = dep
        return model.apply(dp, training=True)

    image1, image2 = pair_downsample(image)
    depth1 = depth2 = None
    if depth is not None:
        depth1, depth2 = pair_downsample(depth)
    e1 = fwd(image1, depth1)["enhanced"]
    e2 = fwd(image2, depth2)["enhanced"]
    outputs = fwd(image, depth)
    e_1, e_2 = pair_downsample(outputs["enhanced"])
    loss_res = 0.5 * (_mse(image1, e2) + _mse(image2, e1))
    loss_con = 0.5 * (_mse(e_1, e1) + _mse(e_2, e2))
    return 0.5 * (loss_res + loss_con) + 0.5 * gce_loss()(outputs, datapoint), outputs


def _gcenet(name: str, num_channels: int, num_iters: int, use_depth: bool, use_edge: bool,
            generator, kwargs: dict) -> Model:
    module = GCENetModule(
        num_channels=num_channels, num_iters=num_iters,
        dba_eps=kwargs.get("dba_eps", 0.05), gf_radius=kwargs.get("gf_radius", 3),
        gf_eps=kwargs.get("gf_eps", 1e-4), bam_gamma=kwargs.get("bam_gamma", 2.6),
        bam_ksize=kwargs.get("bam_ksize", 9), use_depth=use_depth, use_edge=use_edge,
        generator=generator)
    return Model(name=name, arch="gcenet", module=module, tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE), loss_fn=gce_loss(),
                 required_inputs=("image", "depth") if use_depth else ("image",))


@MODELS.register(name="gcenet", arch="gcenet", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def gcenet(num_channels: int = 32, num_iters: int = 15, use_depth: bool = True,
           use_edge: bool = True, generator: torch.Generator | None = None,
           **kwargs) -> Model:
    return _gcenet("gcenet", num_channels, num_iters, use_depth, use_edge, generator, kwargs)


@MODELS.register(name="gcenet_zsn2n", arch="gcenet", tasks=(Task.LLIE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def gcenet_zsn2n(num_channels: int = 32, num_iters: int = 15, use_depth: bool = True,
                 use_edge: bool = True, generator: torch.Generator | None = None,
                 **kwargs) -> Model:
    m = _gcenet("gcenet_zsn2n", num_channels, num_iters, use_depth, use_edge, generator,
                kwargs)
    m.forward_loss_fn = gcenet_zsn2n_forward_loss
    return m


@MODELS.register(name="gcenet_instance", arch="gcenet", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_REFERENCE, Scheme.INSTANCE))
def gcenet_instance(num_channels: int = 32, num_iters: int = 15, use_depth: bool = True,
                    use_edge: bool = True, generator: torch.Generator | None = None,
                    **kwargs) -> Model:
    m = _gcenet("gcenet_instance", num_channels, num_iters, use_depth, use_edge, generator,
                kwargs)
    m.schemes = (Scheme.ZERO_REFERENCE, Scheme.INSTANCE)
    m.instance_steps, m.instance_lr, m.instance_weight_decay = 300, 5e-5, 1e-5
    return m
