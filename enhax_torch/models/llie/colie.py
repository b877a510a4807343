"""CoLIE: context-based low-light enhancement by neural implicit
representations, fitted to each image.

Port of ``enhax/models/llie/colie.py``: two SIREN branches, one over the
unfolded context window of the low-resolution V (or HVI intensity) channel,
one over (x, y) coordinates, joined by a SIREN head that predicts an
illumination residual at ``down_size``; V divided by the illumination,
upsampled by a bicubic fast guided filter, put back as the V channel. The
HVI forms (``colie_hvi``, ``colie_hvid``) learn the HVI ``density_k``;
``colie_hvid`` adds depth and edge context branches (depth optional). The
output is divided by its maximum over the whole batch. 100 AdamW steps an
image through ``Predictor``.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import SineLayer, dense, unit_coords, window_stack
from enhax_torch.nn.layers import boundary_aware_prior
from enhax_torch.nn.losses import _avg_pool, total_variation_loss
from enhax_torch.ops.color import hsv_to_rgb, hvi_to_rgb, rgb_to_hsv, rgb_to_hvi
from enhax_torch.ops.filtering import fast_guided_filter_bicubic
from enhax_torch.ops.resize import resize_bicubic_torch, resize_nearest_torch


class SirenStack(nn.Sequential):
    """Sine layers ``sine{i}`` of widths ``dims`` (the first is SIREN's
    first layer when ``is_first``); with ``final_linear`` the last is a
    plain Dense ``lin{i}`` with SIREN's init."""

    def __init__(self, in_features: int, dims: tuple, is_first: bool = True,
                 omega_0: float = 30.0, final_linear: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        n_in = in_features
        for i, d in enumerate(dims):
            if i == len(dims) - 1 and final_linear:
                self.add_module(f"lin{i}", dense(n_in, d, True, generator, (False, omega_0)))
            else:
                self.add_module(f"sine{i}", SineLayer(n_in, d, is_first=(i == 0 and is_first),
                                                      omega_0=omega_0, generator=generator))
            n_in = d


class CoLIEModule(nn.Module):
    """NHWC image (and depth) -> {"enhanced", "illu_lr", "image_v_lr",
    "image_v_fixed_lr"}, at a fixed ``down_size``."""

    def __init__(self, window_size: int = 7, down_size: int = 256, hidden_dim: int = 256,
                 add_layer: int = 2, num_layers: int = 4, gf_radius: int = 1,
                 gf_eps: float = 1e-8, use_hvi: bool = False, use_depth: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.window_size, self.down_size = window_size, down_size
        self.gf_radius, self.gf_eps = gf_radius, gf_eps
        self.use_hvi, self.use_depth = use_hvi, use_depth
        if use_hvi:
            self.density_k = nn.Parameter(torch.full((1,), 0.2))
        mid = max(add_layer - 2, 0)
        tail = hidden_dim // (4 if use_depth else 2)
        dims = (hidden_dim,) * (1 + mid) + (tail,)
        k2, g = window_size * window_size, generator
        self.patch_net = SirenStack(k2, dims, generator=g)
        self.spatial_net = SirenStack(2, dims, generator=g)
        if use_depth:
            self.patch_d_net = SirenStack(k2, dims, generator=g)
            self.patch_e_net = SirenStack(k2, dims, generator=g)
        out_dims = tuple(hidden_dim for _ in range(add_layer, num_layers - 1)) + (1,)
        self.output_net = SirenStack(tail * (4 if use_depth else 2), out_dims, is_first=False,
                                     final_linear=True, generator=g)

    def _patches(self, t: torch.Tensor) -> torch.Tensor:
        """Reflection-padded context windows of (n, ds, ds, 1): (n, ds*ds, k*k)."""
        p = window_stack(t, self.window_size, "reflect")
        return p.reshape(t.shape[0], self.down_size ** 2, -1)

    def forward(self, x: torch.Tensor, depth: torch.Tensor | None = None) -> dict:
        ds, n = self.down_size, x.shape[0]
        if self.use_hvi:
            k = self.density_k[0]
            hvi = rgb_to_hvi(x, density_k=k)
            v = hvi.detach()[..., 2:3]
            v_lr = resize_nearest_torch(v, (ds, ds))
        else:
            hsv = rgb_to_hsv(x)
            v = hsv[..., 2:3]
            v_lr = resize_bicubic_torch(v, (ds, ds))

        patch_feat = self.patch_net(self._patches(v_lr))
        coords = unit_coords(ds, n, x.device, x.dtype).reshape(n, ds * ds, 2)
        spatial_feat = self.spatial_net(coords)
        feats = [patch_feat, spatial_feat]
        if self.use_depth:
            if depth is None:
                depth = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
            edge = boundary_aware_prior(depth, eps=0.05, normalized=False)
            d_feat = self.patch_d_net(self._patches(resize_nearest_torch(depth, (ds, ds))))
            e_feat = self.patch_e_net(self._patches(resize_nearest_torch(edge, (ds, ds))))
            feats = [patch_feat, e_feat, d_feat, spatial_feat]
        illu_res = self.output_net(torch.cat(feats, dim=-1))
        illu_lr = illu_res.reshape(n, ds, ds, 1) + v_lr
        v_fixed_lr = v_lr / (illu_lr + 1e-4)
        v_fixed = fast_guided_filter_bicubic(v_lr, v_fixed_lr, v, radius=self.gf_radius,
                                             eps=self.gf_eps).clamp(0.0, 1.0)
        if self.use_hvi:
            rgb = hvi_to_rgb(torch.cat([hvi[..., :2], v_fixed], dim=-1), density_k=k)
        else:
            rgb = hsv_to_rgb(torch.cat([hsv[..., :2], v_fixed], dim=-1))
        return {"enhanced": rgb / rgb.max(), "illu_lr": illu_lr, "image_v_lr": v_lr,
                "image_v_fixed_lr": v_fixed_lr}


def colie_loss(L: float = 0.3, alpha: float = 1.0, beta: float = 20.0, gamma: float = 8.0,
               delta: float = 5.0):
    """alpha |illu - v|^2 + beta TV(illu) + gamma (exposure value of illu,
    the sqrt form) + delta mean(v fixed), all at ``down_size``."""
    tv = total_variation_loss()

    def fn(outputs: dict, datapoint: dict) -> torch.Tensor:
        illu = outputs["illu_lr"]
        pooled = _avg_pool(illu.mean(dim=-1, keepdim=True), 16).mean(dim=-1, keepdim=True)
        loss_exp = ((torch.sqrt(pooled.clamp_min(0.0)) - L) ** 2).mean().abs()
        loss_spa = ((illu - outputs["image_v_lr"]) ** 2).abs().mean()
        loss_sparsity = outputs["image_v_fixed_lr"].mean()
        return alpha * loss_spa + beta * tv(illu) + gamma * loss_exp + delta * loss_sparsity
    return fn


def _make_colie(name: str, use_hvi: bool = False, use_depth: bool = False,
                generator: torch.Generator | None = None, **kw) -> Model:
    return Model(
        name=name, arch="colie",
        module=CoLIEModule(window_size=kw.get("window_size", 7),
                           down_size=kw.get("down_size", 256),
                           hidden_dim=kw.get("hidden_dim", 256),
                           add_layer=kw.get("add_layer", 2),
                           num_layers=kw.get("num_layers", 4),
                           use_hvi=use_hvi, use_depth=use_depth, generator=generator),
        tasks=(Task.LLIE,),
        schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE, Scheme.INSTANCE),
        loss_fn=colie_loss(L=kw.get("L", 0.3), alpha=kw.get("alpha", 1.0),
                           beta=kw.get("beta", 20.0), gamma=kw.get("gamma", 8.0),
                           delta=kw.get("delta", 5.0)),
        required_inputs=("image",),
        optional_inputs=("depth",) if use_depth else (),
        instance_steps=kw.get("instance_steps", 100),
        instance_lr=kw.get("instance_lr", 1e-5),
        instance_weight_decay=kw.get("instance_weight_decay", 3e-4),
    )


@MODELS.register(name="colie_re", arch="colie", aliases=["colie"], tasks=(Task.LLIE,),
                 schemes=(Scheme.INSTANCE,))
def colie_re(**kwargs) -> Model:
    return _make_colie("colie_re", **kwargs)


@MODELS.register(name="colie_hvi", arch="colie", tasks=(Task.LLIE,), schemes=(Scheme.INSTANCE,))
def colie_hvi(**kwargs) -> Model:
    return _make_colie("colie_hvi", use_hvi=True, **kwargs)


@MODELS.register(name="colie_hvid", arch="colie", tasks=(Task.LLIE,),
                 schemes=(Scheme.INSTANCE,))
def colie_hvid(**kwargs) -> Model:
    return _make_colie("colie_hvid", use_hvi=True, use_depth=True, **kwargs)
