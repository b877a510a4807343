"""Zero-MIE: multimodal implicit enhancement, fitted to each image.

Port of ``enhax/models/llie/zero_mie.py``:
  * ``ZeroMIEModule`` (``zero_mie`` and its hsv / rgb_d / hsv_d colour
    spaces and finer / gauss / relu layers): an INR predicts an
    illumination residual at ``down_size`` from a context encoder over the
    low-resolution image and a coordinate encoder, with depth and edge
    encoders in the ``_d`` spaces (optionally ``FiLM`` by depth and
    ``CrossAttentionLayer``); division by the illumination, a bicubic fast
    guided filter up, division by the maximum over the batch.
  * ``ZeroMIEMSModule`` (``zero_mie_ms`` and its eight ``_wo_*`` ablations,
    which differ only in their configs): one value encoder per window size,
    optional Gaussian Fourier features on the coordinates (the matrix ``B``
    a parameter the forward detaches, so the instance fit decays it as the
    JAX package's AdamW does), a depth-gamma illumination branch, no
    division by the maximum.

The decoder's (ds, ds, C) output is read as (C, ds, ds), a raw
reinterpretation as upstream's ``.view``: with 3 channels it scrambles them,
and it is reproduced so. Encoders are ``nn.Sequential``s of INR layers
(``value_net.0`` for the JAX package's ``value_net_net0``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import dense, make_layer, unit_coords, window_stack
from enhax_torch.nn.layers import boundary_aware_prior
from enhax_torch.nn.losses import (color_constancy_loss, depth_weighted_smoothness_loss,
                                   edge_aware_depth_consistency_loss, edge_aware_loss,
                                   exposure_control_loss, exposure_value_control_loss,
                                   spatial_consistency_loss, total_variation_loss)
from enhax_torch.ops.color import hsv_to_rgb, rgb_to_grayscale, rgb_to_hsv
from enhax_torch.ops.filtering import bilateral_blur, fast_guided_filter_bicubic
from enhax_torch.ops.resize import resize_bicubic_torch


class FiLM(nn.Module):
    """x * Dense(cond) + Dense(cond) (no identity offset)."""

    def __init__(self, cond_features: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc_scale = dense(cond_features, features, generator=generator)
        self.fc_shift = dense(cond_features, features, generator=generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return x * self.fc_scale(cond) + self.fc_shift(cond)


class DotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (no dropout, no mask): q, k, v
    projections to ``heads`` x ``dim / heads``, softmax(q k^T / sqrt(head
    dim)) over the second-to-last axis (the others are batch axes), the
    heads joined by ``out``. The projections are ``nn.Linear``s over the
    flattened (heads, head_dim) axis."""

    def __init__(self, dim: int, num_heads: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.query = dense(dim, dim, generator=generator)
        self.key = dense(dim, dim, generator=generator)
        self.value = dense(dim, dim, generator=generator)
        self.out = dense(dim, dim, generator=generator)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        h = self.num_heads

        def heads(t):
            return t.reshape(*t.shape[:-1], h, t.shape[-1] // h)

        q, k, v = heads(self.query(query)), heads(self.key(key)), heads(self.value(value))
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        y = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out(y.reshape(*y.shape[:-2], -1))


class CrossAttentionLayer(nn.Module):
    """Attention with query = value features, key = edge, value = depth
    (off by default, as upstream leaves it commented out)."""

    def __init__(self, dim: int, num_heads: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.attn = DotProductAttention(dim, num_heads, generator)

    def forward(self, query, key, value):
        return self.attn(query, key, value)


def inr_stack(in_features: int, mid: int, n_layers: int, nonlinear: str, omega_0: float,
              first_bias_scale: float | None, generator) -> nn.Sequential:
    """``n_layers + 1`` INR layers of width ``mid``, the first SIREN's first
    layer, no trailing linear."""
    return nn.Sequential(*[
        make_layer(nonlinear, in_features if i == 0 else mid, mid, i == 0, omega_0,
                   first_bias_scale=first_bias_scale, generator=generator)
        for i in range(n_layers + 1)])


def decoder(width: int, out_ch: int, out_layers: int, nonlinear: str, omega_0: float,
            generator) -> nn.Sequential:
    """``out_layers`` INR layers (width -> width), then a Dense to ``out_ch``
    (sigmoid applied by the caller)."""
    layers = [make_layer(nonlinear, width, width, False, omega_0, generator=generator)
              for _ in range(out_layers)]
    return nn.Sequential(*layers, dense(width, out_ch, generator=generator))


def context(x_lr: torch.Tensor, k: int) -> torch.Tensor:
    """The encoders' reflection-padded k x k windows of channel 0."""
    return window_stack(x_lr, k, "reflect")


def as_channels_first(y: torch.Tensor, n: int, out_ch: int, ds: int) -> torch.Tensor:
    """Upstream's ``.view(1, C, ds, ds)`` of a (ds, ds, C) map, back to NHWC."""
    return y.reshape(n, out_ch, ds, ds).permute(0, 2, 3, 1)


class ZeroMIEModule(nn.Module):
    """The single-scale MLP_{RGB,RGB_D,HSV,HSV_D}: NHWC image (and depth)
    -> enhanced, illu_lr, image_lr, enhanced_lr, depth_lr, edge_lr, edge."""

    def __init__(self, color_space: str = "rgb", window_size: int = 7,
                 hidden_channels: int = 256, down_size: int = 256, hidden_layers: int = 2,
                 out_layers: int = 1, omega_0: float = 30.0,
                 first_bias_scale: float | None = 20.0, nonlinear: str = "sine",
                 dba_eps: float = 0.05, gf_radius: int = 3, use_film: bool = False,
                 use_cross_attn: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.color_space, self.window_size, self.down_size = color_space, window_size, down_size
        self.dba_eps, self.gf_radius = dba_eps, gf_radius
        self.use_film, self.use_cross_attn = use_film, use_cross_attn
        self.multimodal = color_space.endswith("_d")
        self.out_ch = 1 if color_space.startswith("hsv") else 3
        mid = hidden_channels // (4 if self.multimodal else 2)
        g, k2 = generator, window_size * window_size

        def stack(n_in):
            return inr_stack(n_in, mid, hidden_layers, nonlinear, omega_0, first_bias_scale, g)

        self.value_net = stack(k2)
        self.coords_net = stack(2)
        if self.multimodal:
            self.depth_net = stack(k2)
            self.edge_net = stack(k2)
            if use_film:
                self.film = FiLM(1, mid, g)
            if use_cross_attn:
                self.cross_attn = CrossAttentionLayer(mid, generator=g)
        width = mid * (4 if self.multimodal else 2)
        self.output_net = decoder(width, self.out_ch, out_layers, nonlinear, omega_0, g)

    def forward(self, image: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        cs, ds, n = self.color_space, self.down_size, image.shape[0]
        if depth is None:
            depth = rgb_to_grayscale(image)
        edge = boundary_aware_prior(depth, eps=self.dba_eps, normalized=False)
        if cs.startswith("hsv"):
            image_hsv = rgb_to_hsv(image)
            base = image_hsv[..., 2:3]
        else:
            base = image
        base_lr = resize_bicubic_torch(base, (ds, ds))
        value_inr = self.value_net(context(base_lr, self.window_size))
        depth_lr = resize_bicubic_torch(depth, (ds, ds))
        edge_lr = resize_bicubic_torch(edge, (ds, ds))
        coords_inr = self.coords_net(unit_coords(ds, n, image.device, image.dtype))
        if self.multimodal:
            depth_inr = self.depth_net(context(depth_lr, self.window_size))
            edge_inr = self.edge_net(context(edge_lr, self.window_size))
            if self.use_film:
                value_inr = self.film(value_inr, depth_lr)
            if self.use_cross_attn:
                value_inr = self.cross_attn(value_inr, edge_inr, depth_inr)
            if cs == "hsv_d":
                feats = [value_inr, edge_inr, depth_inr, coords_inr]
            else:
                feats = [value_inr, depth_inr, edge_inr, coords_inr]
        else:
            feats = [value_inr, coords_inr]
        y = torch.sigmoid(self.output_net(torch.cat(feats, dim=-1)))
        illu_lr = as_channels_first(y, n, self.out_ch, ds) + base_lr
        enhanced_lr = base_lr / (illu_lr + 1e-8)
        enhanced_base = fast_guided_filter_bicubic(base_lr, enhanced_lr, base,
                                                   radius=self.gf_radius).clamp(0, 1)
        if cs.startswith("hsv"):
            enhanced = hsv_to_rgb(torch.cat([image_hsv[..., 0:2], enhanced_base], dim=-1))
        else:
            enhanced = enhanced_base
        return {"enhanced": enhanced / enhanced.max(), "illu_lr": illu_lr, "image_lr": base_lr,
                "enhanced_lr": enhanced_lr, "depth_lr": depth_lr, "edge_lr": edge_lr,
                "edge": edge}


def zero_mie_loss(exp_mean: float = 0.6, exp_weight: float = 10.0, spa_weight: float = 1.0,
                  color_weight: float = 5.0, tv_weight: float = 1600.0,
                  depth_weight: float = 1.0, edge_weight: float = 1.0):
    """The rgb loss on the full-resolution pair (spatial consistency over 8
    regions), TV of the illumination and the edge-aware depth consistency
    of the low-resolution output (upstream's depth term does not exist and
    is left out, as in the JAX package)."""
    exp = exposure_control_loss(patch_size=16, mean_val=exp_mean)
    spa = spatial_consistency_loss(num_regions=8)
    col, tv = color_constancy_loss(), total_variation_loss()
    edc = edge_aware_depth_consistency_loss()

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        enhanced = outputs["enhanced"]
        return (exp_weight * exp(enhanced) + spa_weight * spa(enhanced, datapoint["image"])
                + color_weight * col(enhanced) + tv_weight * tv(outputs["illu_lr"])
                + edge_weight * edc(outputs["enhanced_lr"], outputs["depth_lr"]))
    return fn


def zero_mie_hsv_loss(exp_mean: float = 0.6, exp_weight: float = 8.0, spa_weight: float = 1.0,
                      tv_weight: float = 20.0, spar_weight: float = 5.0,
                      color_weight: float = 5.0, depth_weight: float = 1.0,
                      edge_weight: float = 1.0):
    """LossHSV: exposure value of the low-resolution illumination (E = 1 -
    exp_mean), its squared distance from the image, TV, sparsity, colour
    constancy and the edge-aware depth consistency."""
    exp = exposure_value_control_loss(patch_size=16, mean_val=1.0 - exp_mean)
    tv, col = total_variation_loss(), color_constancy_loss()
    edc = edge_aware_depth_consistency_loss()

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        illu_lr, enhanced = outputs["illu_lr"], outputs["enhanced"]
        return (exp_weight * exp(illu_lr)
                + spa_weight * ((illu_lr - outputs["image_lr"]) ** 2).abs().mean()
                + tv_weight * tv(illu_lr) + spar_weight * enhanced.mean()
                + color_weight * col(enhanced)
                + edge_weight * edc(outputs["enhanced_lr"], outputs["depth_lr"]))
    return fn


class ZeroMIEMSModule(nn.Module):
    """ZeroMIE_MS: one value encoder per window size (``value_net{i}``),
    ``hidden_channels // 2`` features each; the ``_d`` spaces add depth and
    edge encoders at the last window, concatenated as [values, depth, edge,
    coords]; optional Fourier features ``B`` on the coordinates; the
    enhanced image from the depth-gamma illumination while the loss sees the
    unmodulated one; optional bilateral denoise of the low-resolution
    output; no division by the maximum."""

    def __init__(self, color_space: str = "hsv", window_size: tuple = (3, 5, 7),
                 hidden_channels: int = 256, down_size: int = 256, hidden_layers: int = 2,
                 out_layers: int = 1, omega_0: float = 30.0,
                 first_bias_scale: float | None = None, nonlinear: str = "sine",
                 use_ff: bool = False, ff_gaussian_scale: float = 10.0, dba_eps: float = 0.05,
                 depth_gamma: float = 0.7, gf_radius: int = 3, use_denoise: bool = False,
                 denoise_ksize: tuple = (3, 3), denoise_color: float = 0.5,
                 denoise_space: tuple = (1.5, 1.5), generator: torch.Generator | None = None):
        super().__init__()
        self.color_space, self.down_size = color_space, down_size
        self.window_size = tuple(int(k) for k in window_size)
        self.dba_eps, self.depth_gamma, self.gf_radius = dba_eps, depth_gamma, gf_radius
        self.use_ff, self.use_denoise = use_ff, use_denoise
        self.denoise = (tuple(int(v) for v in denoise_ksize), denoise_color,
                        tuple(denoise_space))
        self.multimodal = color_space.endswith("_d")
        self.out_ch = 1 if color_space.startswith("hsv") else 3
        mid = hidden_channels // 2
        g = generator

        def stack(n_in):
            return inr_stack(n_in, mid, hidden_layers, nonlinear, omega_0, first_bias_scale, g)

        for i, k in enumerate(self.window_size):
            self.add_module(f"value_net{i}", stack(k * k))
        if use_ff:
            self.B = nn.Parameter(torch.randn(mid, 2, generator=g) * ff_gaussian_scale)
        self.coords_net = stack(2 * mid if use_ff else 2)
        if self.multimodal:
            self.depth_net = stack(self.window_size[-1] ** 2)
            self.edge_net = stack(self.window_size[-1] ** 2)
        width = mid * (len(self.window_size) + (3 if self.multimodal else 1))
        self.output_net = decoder(width, self.out_ch, out_layers, nonlinear, omega_0, g)

    def forward(self, image: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        cs, ds, n = self.color_space, self.down_size, image.shape[0]
        if depth is None:
            depth = rgb_to_grayscale(image)
        edge = boundary_aware_prior(depth, eps=self.dba_eps, normalized=False)
        if cs.startswith("hsv"):
            image_hsv = rgb_to_hsv(image)
            base = image_hsv[..., 2:3]
        else:
            base = image
        base_lr = resize_bicubic_torch(base, (ds, ds))
        values = [getattr(self, f"value_net{i}")(context(base_lr, k))
                  for i, k in enumerate(self.window_size)]
        coords = unit_coords(ds, n, image.device, image.dtype)
        if self.use_ff:
            proj = 2.0 * math.pi * coords @ self.B.detach().T
            coords = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        coords_inr = self.coords_net(coords)
        depth_lr = resize_bicubic_torch(depth, (ds, ds))
        edge_lr = resize_bicubic_torch(edge, (ds, ds))
        if self.multimodal:
            k = self.window_size[-1]
            feats = values + [self.depth_net(context(depth_lr, k)),
                              self.edge_net(context(edge_lr, k)), coords_inr]
        else:
            feats = values + [coords_inr]
        y = torch.sigmoid(self.output_net(torch.cat(feats, dim=-1)))
        illu_res_lr = as_channels_first(y, n, self.out_ch, ds)
        illu_lr = base_lr + illu_res_lr
        illu_res_lr2 = illu_res_lr * (1.0 + self.depth_gamma * (1.0 - depth_lr / depth_lr.max()))
        illu_lr2 = base_lr + illu_res_lr2
        enhanced_lr = base_lr / (illu_lr2 + 1e-8)
        if self.use_denoise:
            enhanced_lr = bilateral_blur(enhanced_lr, *self.denoise)
        enhanced_base = fast_guided_filter_bicubic(base_lr, enhanced_lr, base,
                                                   radius=self.gf_radius).clamp(0, 1)
        if cs.startswith("hsv"):
            enhanced = hsv_to_rgb(torch.cat([image_hsv[..., 0:2], enhanced_base], dim=-1))
        else:
            enhanced = enhanced_base
        return {"enhanced": enhanced, "illu_lr": illu_lr, "illu_lr2": illu_lr2,
                "illu_res_lr": illu_res_lr, "illu_res_lr2": illu_res_lr2, "image_lr": base_lr,
                "enhanced_lr": enhanced_lr, "depth_lr": depth_lr, "edge_lr": edge_lr,
                "edge": edge, "depth": depth}


def zero_mie_ms_loss(exp_mean: float = 0.7, exp_weight: float = 10.0, spa_weight: float = 1.0,
                     color_weight: float = 5.0, tv_weight: float = 20.0,
                     depth_weight: float = 1.0, edge_weight: float = 1.0, **_):
    """The MS rgb loss: exposure, spatial and colour terms of the enhanced
    image; TV, depth-weighted smoothness and edge-aware terms of the
    unmodulated low-resolution illumination."""
    exp = exposure_control_loss(patch_size=16, mean_val=exp_mean)
    spa = spatial_consistency_loss(num_regions=8)
    col, tv = color_constancy_loss(), total_variation_loss()
    dws, ea = depth_weighted_smoothness_loss(), edge_aware_loss()

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        enhanced, illu_lr = outputs["enhanced"], outputs["illu_lr"]
        return (exp_weight * exp(enhanced) + spa_weight * spa(enhanced, datapoint["image"])
                + color_weight * col(enhanced) + tv_weight * tv(illu_lr)
                + depth_weight * dws(illu_lr, outputs["depth_lr"])
                + edge_weight * ea(illu_lr, outputs["edge_lr"]))
    return fn


def zero_mie_ms_hsv_loss(exp_mean: float = 0.7, exp_weight: float = 10.0,
                         spa_weight: float = 1.0, tv_weight: float = 20.0,
                         spar_weight: float = 5.0, color_weight: float = 5.0,
                         depth_weight: float = 1.0, edge_weight: float = 1.0, **_):
    """The MS LossHSV: the hsv loss's terms with the depth-weighted
    smoothness and edge-aware terms in place of the depth consistency."""
    exp = exposure_value_control_loss(patch_size=16, mean_val=1.0 - exp_mean)
    tv, col = total_variation_loss(), color_constancy_loss()
    dws, ea = depth_weighted_smoothness_loss(), edge_aware_loss()

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        illu_lr, enhanced = outputs["illu_lr"], outputs["enhanced"]
        return (exp_weight * exp(illu_lr)
                + spa_weight * ((illu_lr - outputs["image_lr"]) ** 2).abs().mean()
                + tv_weight * tv(illu_lr) + spar_weight * enhanced.mean()
                + color_weight * col(enhanced)
                + depth_weight * dws(illu_lr, outputs["depth_lr"])
                + edge_weight * ea(illu_lr, outputs["edge_lr"]))
    return fn


_SCHEMES = (Scheme.ZERO_REFERENCE, Scheme.INSTANCE, Scheme.ZERO_SHOT)


def _make(name: str, nonlinear: str = "sine", color_space: str = "rgb",
          generator: torch.Generator | None = None, **kw) -> Model:
    module = ZeroMIEModule(color_space=color_space, nonlinear=nonlinear,
                           window_size=kw.get("window_size", 7),
                           down_size=kw.get("down_size", 256),
                           hidden_channels=kw.get("hidden_channels", 256),
                           use_film=kw.get("use_film", False),
                           use_cross_attn=kw.get("use_cross_attn", False), generator=generator)
    return Model(
        name=name, arch="zero_mie", module=module, tasks=(Task.LLIE,), schemes=_SCHEMES,
        loss_fn=zero_mie_hsv_loss() if color_space.startswith("hsv") else zero_mie_loss(),
        required_inputs=("image",),
        instance_steps=kw.get("instance_steps", 300), instance_lr=kw.get("instance_lr", 1e-5))


_LOSS_KEYS = ("exp_mean", "exp_weight", "spa_weight", "tv_weight", "spar_weight",
              "depth_weight", "edge_weight", "color_weight")


def _make_ms(name: str, generator: torch.Generator | None = None, **kw) -> Model:
    """ZeroMIE_MS with the model-level loss keywords (``loss_hsv``,
    ``exp_mean``, the weights) as the JAX package's ``_make_ms`` takes them."""
    color_space = kw.pop("color_space", "hsv")
    loss_hsv = kw.pop("loss_hsv", True)
    loss_kw = {k: kw.pop(k) for k in _LOSS_KEYS if k in kw}
    module = ZeroMIEMSModule(
        color_space=color_space,
        window_size=tuple(int(w) for w in kw.pop("window_size", (3, 5, 7))),
        hidden_channels=kw.pop("hidden_channels", 256), down_size=kw.pop("down_size", 256),
        hidden_layers=kw.pop("hidden_layers", 2), out_layers=kw.pop("out_layers", 1),
        omega_0=kw.pop("omega_0", 30.0), first_bias_scale=kw.pop("first_bias_scale", None),
        nonlinear=kw.pop("nonlinear", "sine"), use_ff=kw.pop("use_ff", False),
        ff_gaussian_scale=kw.pop("ff_gaussian_scale", 10.0),
        dba_eps=kw.pop("edge_threshold", 0.05), depth_gamma=kw.pop("depth_gamma", 0.7),
        gf_radius=kw.pop("gf_radius", 3), use_denoise=kw.pop("use_denoise", False),
        denoise_ksize=tuple(kw.pop("denoise_ksize", (3, 3))),
        denoise_color=kw.pop("denoise_color", 0.5),
        denoise_space=tuple(kw.pop("denoise_space", (1.5, 1.5))), generator=generator)
    if loss_hsv and "hsv" in color_space:
        loss_fn = zero_mie_ms_hsv_loss(**loss_kw)
    else:
        loss_fn = zero_mie_ms_loss(**loss_kw)
    return Model(
        name=name, arch="zero_mie", module=module, tasks=(Task.LLIE,), schemes=_SCHEMES,
        loss_fn=loss_fn, required_inputs=("image",), optional_inputs=("depth",),
        instance_steps=kw.pop("instance_steps", 10), instance_lr=kw.pop("instance_lr", 1e-5),
        instance_weight_decay=kw.pop("instance_weight_decay", 3e-4))


@MODELS.register(name="zero_mie", arch="zero_mie", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_SHOT,))
def zero_mie(**kwargs) -> Model:
    return _make("zero_mie", color_space="rgb", **kwargs)


@MODELS.register(name="zero_mie_rgb_d", arch="zero_mie", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_SHOT,))
def zero_mie_rgb_d(**kwargs) -> Model:
    return _make("zero_mie_rgb_d", color_space="rgb_d", **kwargs)


@MODELS.register(name="zero_mie_hsv", arch="zero_mie", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_SHOT,))
def zero_mie_hsv(**kwargs) -> Model:
    return _make("zero_mie_hsv", color_space="hsv", **kwargs)


@MODELS.register(name="zero_mie_hsv_d", arch="zero_mie", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_SHOT,))
def zero_mie_hsv_d(**kwargs) -> Model:
    return _make("zero_mie_hsv_d", color_space="hsv_d", **kwargs)


for _nl in ("finer", "gauss", "relu"):
    def _builder(nl=_nl, **kwargs):
        return _make(f"zero_mie_{nl}", nonlinear=nl, **kwargs)
    MODELS.register(name=f"zero_mie_{_nl}", obj=_builder, arch="zero_mie", tasks=(Task.LLIE,),
                    schemes=(Scheme.ZERO_SHOT,))


@MODELS.register(name="zero_mie_ms", arch="zero_mie", tasks=(Task.LLIE,),
                 schemes=(Scheme.ZERO_SHOT,))
def zero_mie_ms(**kwargs) -> Model:
    return _make_ms("zero_mie_ms", **kwargs)


# the eight ablations are the same model; their configs zero one knob each
for _aname in ("zero_mie_ms_wo_color", "zero_mie_ms_wo_depth", "zero_mie_ms_wo_edge",
               "zero_mie_ms_wo_exp", "zero_mie_ms_wo_ff", "zero_mie_ms_wo_spa",
               "zero_mie_ms_wo_spar", "zero_mie_ms_wo_tv"):
    def _ab_builder(nm=_aname, **kwargs):
        return _make_ms(nm, **kwargs)
    MODELS.register(name=_aname, obj=_ab_builder, arch="zero_mie", tasks=(Task.LLIE,),
                    schemes=(Scheme.ZERO_SHOT,))
