"""ZID: zero-shot image dehazing (a deep image prior fitted to each image).

Port of ``enhax/models/dehaze/zid.py``:
  * ``DIPSkipNet``: the recursive hourglass, per level a 1x1 skip branch
    (levels 4 and 5) beside a stride-2 double conv that recurses and is
    upsampled (bilinear, ``align_corners=True``); concat, BN, 3x3 conv, 1x1
    conv, reflection padding, LeakyReLU(0.01), sigmoid head;
  * ``AmbientVAE``: a conv encoder to a 100-d latent (its fcs over the NCHW
    flattening), a decoder of bilinear x2 upsamplings and 5x5 convs to a
    full-resolution ambient image, and its KL (a sum);
  * ``color_guided_filter``: He et al.'s guided filter with an RGB guide
    (radius 50, eps 1e-4), a 3x3 solve per pixel;
  * the loss (``zid_forward_loss``): composition, KL, StdLoss of mask and
    ambient, the dark channel toward zero, and the ambient toward the dark
    channel prior's airlight (``atmospheric_prior``, top-k).

The BatchNorms normalise with their running statistics (flax's
``use_running_average=True``), and the statistics are parameters
(``FrozenBatchNorm2d``): the instance fit steps them, as the JAX package's
fit steps ``batch_stats``. The VAE's fcs fix the image size (``image_size``,
default 128x128). 500 Adam steps at lr 1e-3 an image through ``Predictor``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import dense
from enhax_torch.nn.layers import FrozenBatchNorm2d, flax_conv2d


class ReflectConv(nn.Conv2d):
    """Reflection padding of (k - 1) // 2, then a VALID conv (NCHW)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = (self.kernel_size[0] - 1) // 2
        return super().forward(F.pad(x, (p,) * 4, mode="reflect") if p else x)


def reflect_conv(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 generator: torch.Generator | None = None) -> ReflectConv:
    return flax_conv2d(in_channels, out_channels, kernel, stride, padding=0,
                       generator=generator, cls=ReflectConv)


class DIPSkipNet(nn.Module):
    """encoder_decoder_skip on NCHW maps; submodules under the JAX
    package's names (``l{i}_d1``, ``l{i}_d1_bn``, ..., ``out_conv``)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 channels_down: tuple = (8, 16, 32, 64, 128),
                 channels_skip: tuple = (0, 0, 0, 4, 4), sigmoid: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        cd, cs, g = channels_down, channels_skip, generator
        self.cd, self.cs, self.sigmoid = cd, cs, sigmoid
        last = len(cd) - 1
        c_in = in_channels
        for i in range(len(cd)):
            if cs[i]:
                self.add_module(f"l{i}_skip_conv", reflect_conv(c_in, cs[i], 1, generator=g))
                self.add_module(f"l{i}_skip_bn", FrozenBatchNorm2d(cs[i]))
            self.add_module(f"l{i}_d1", reflect_conv(c_in, cd[i], 3, 2, g))
            self.add_module(f"l{i}_d1_bn", FrozenBatchNorm2d(cd[i]))
            self.add_module(f"l{i}_d2", reflect_conv(cd[i], cd[i], 3, generator=g))
            self.add_module(f"l{i}_d2_bn", FrozenBatchNorm2d(cd[i]))
            c_cat = cs[i] + (cd[i + 1] if i < last else cd[i])
            self.add_module(f"l{i}_cat_bn", FrozenBatchNorm2d(c_cat))
            self.add_module(f"l{i}_u1", reflect_conv(c_cat, cd[i], 3, generator=g))
            self.add_module(f"l{i}_u1_bn", FrozenBatchNorm2d(cd[i]))
            self.add_module(f"l{i}_u2", reflect_conv(cd[i], cd[i], 1, generator=g))
            self.add_module(f"l{i}_u2_bn", FrozenBatchNorm2d(cd[i]))
            c_in = cd[i]
        self.out_conv = reflect_conv(cd[0], out_channels, 1, generator=g)

    def _level(self, x: torch.Tensor, i: int) -> torch.Tensor:
        m = self._modules

        def cbr(t, name):
            return F.leaky_relu(m[f"{name}_bn"](m[name](t)), 0.01)

        s = None
        if self.cs[i]:
            s = F.leaky_relu(m[f"l{i}_skip_bn"](m[f"l{i}_skip_conv"](x)), 0.01)
        d = cbr(cbr(x, f"l{i}_d1"), f"l{i}_d2")
        if i < len(self.cd) - 1:
            d = self._level(d, i + 1)
        d = F.interpolate(d, scale_factor=2, mode="bilinear", align_corners=True)
        y = torch.cat([s, d], dim=1) if s is not None else d
        y = m[f"l{i}_cat_bn"](y)
        return cbr(cbr(y, f"l{i}_u1"), f"l{i}_u2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.out_conv(self._level(x, 0))
        return torch.sigmoid(y) if self.sigmoid else y


class AmbientVAE(nn.Module):
    """The variational autoencoder on NCHW maps: (ambient, KL)."""

    def __init__(self, size: tuple = (128, 128), generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.h16, self.w16 = size[0] // 16, size[1] // 16
        widths = (3, 16, 32, 64, 128)
        for i in range(4):
            self.add_module(f"enc_conv{i + 1}", flax_conv2d(widths[i], widths[i + 1], 5,
                                                            generator=g))
        flat = 128 * self.h16 * self.w16
        self.fc1 = dense(flat, 100, generator=g)
        self.fc2 = dense(flat, 100, generator=g)
        self.linear0 = dense(100, flat, generator=g)
        for i, (a, b) in enumerate(((128, 64), (64, 32), (32, 16))):
            self.add_module(f"de_conv{i + 1}", flax_conv2d(a, b, 5, generator=g))
            self.add_module(f"de_bn{i + 1}", FrozenBatchNorm2d(b))
        self.de_conv4 = flax_conv2d(16, 3, 5, generator=g)

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None) -> tuple:
        m = self._modules
        y = x
        for i in range(4):
            y = F.max_pool2d(torch.relu(m[f"enc_conv{i + 1}"](y)), 2)
        flat = y.reshape(y.shape[0], -1)
        mu, logvar = self.fc1(flat), self.fc2(flat)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        d = self.linear0(z).reshape(-1, 128, self.h16, self.w16)
        for i in range(3):
            d = F.interpolate(d, scale_factor=2, mode="bilinear", align_corners=False)
            d = torch.relu(m[f"de_bn{i + 1}"](m[f"de_conv{i + 1}"](d)))
        d = F.interpolate(d, scale_factor=2, mode="bilinear", align_corners=False)
        d = torch.sigmoid(self.de_conv4(d))
        kl = 0.5 * (torch.exp(logvar) + mu ** 2 - 1 - logvar).sum()
        return d, kl


def _box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Window mean of (N, H, W, C) over (2r+1)^2 pixels with reflect-101
    borders (cv2.boxFilter's default), by running sums."""
    k = 2 * radius + 1
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x.permute(0, 3, 1, 2), (radius,) * 4, mode="reflect").permute(0, 2, 3, 1)
    c = F.pad(xp.cumsum(1).cumsum(2), (0, 0, 1, 0, 1, 0))
    s = c[:, k:k + h, k:k + w] - c[:, :h, k:k + w] - c[:, k:k + h, :w] + c[:, :h, :w]
    return s / (k * k)


def color_guided_filter(guide_rgb: torch.Tensor, src: torch.Tensor, radius: int = 50,
                        eps: float = 1e-4) -> torch.Tensor:
    """He et al.'s colour guided filter (cv2.ximgproc.guidedFilter with a
    3-channel guide): per pixel a = (Sigma_I + eps)^-1 cov(I, p), b =
    mean(p) - a . mean(I), averaged over the window. Taken in float64: in
    float32 E[II] - E[I]E[I] over 101 x 101 windows cancels, and the 3x3
    solve amplifies what is left (the JAX package's float32 result is far
    from its own float64 evaluation)."""
    dtype = src.dtype
    I, p = guide_rgb.double(), src.double()
    mean_I = _box_mean(I, radius)
    mean_p = _box_mean(p, radius)
    cov_Ip = _box_mean(I * p, radius) - mean_I * mean_p
    outer = (I[..., :, None] * I[..., None, :]).reshape(*I.shape[:-1], 9)
    mean_II = _box_mean(outer, radius).reshape(*I.shape[:-1], 3, 3)
    var_I = mean_II - mean_I[..., :, None] * mean_I[..., None, :]
    A = var_I + eps * torch.eye(3, dtype=I.dtype, device=I.device)
    a = torch.linalg.solve(A, cov_Ip[..., None])[..., 0]
    b = mean_p[..., 0] - (a * mean_I).sum(dim=-1)
    q = (_box_mean(a, radius) * I).sum(dim=-1, keepdim=True) + _box_mean(b[..., None], radius)
    return q.to(dtype)


class ZIDModule(nn.Module):
    """NHWC hazy image -> {"image", "mask", "ambient", "enhanced", "vae_kl"}."""

    def __init__(self, size: tuple = (128, 128), clip_t: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.clip_t = clip_t
        self.image_net = DIPSkipNet(3, 3, generator=generator)
        self.mask_net = DIPSkipNet(3, 1, generator=generator)
        self.ambient_net = AmbientVAE(tuple(size), generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        xc = x.permute(0, 3, 1, 2)
        image = self.image_net(xc).permute(0, 2, 3, 1)
        mask = self.mask_net(xc).permute(0, 2, 3, 1)
        ambient, kl = self.ambient_net(xc)
        ambient = ambient.permute(0, 2, 3, 1)
        a = ambient.clamp(0, 1)
        t = color_guided_filter(x, mask.clamp(0, 1), radius=50, eps=1e-4)
        t = t.clamp(0.1 if self.clip_t else 0.0, 1.0)
        y = ((x - (1 - t) * a) / t).clamp(0, 1)
        return {"image": image, "mask": mask, "ambient": ambient, "enhanced": y, "vae_kl": kl}


def dark_channel(x: torch.Tensor, kernel_size: int = 15) -> torch.Tensor:
    """The channel minimum of (N, H, W, 3), eroded over kernel_size^2
    (edge padding): (N, H, W, 1)."""
    pad = kernel_size // 2
    dark = x.min(dim=-1, keepdim=True).values.permute(0, 3, 1, 2)
    dark = F.pad(dark, (pad,) * 4, mode="replicate")
    return -F.max_pool2d(-dark, kernel_size, stride=1).permute(0, 2, 3, 1)


def atmospheric_prior(x: torch.Tensor, kernel_size: int = 15, p: float = 1e-4) -> torch.Tensor:
    """The dark channel prior's airlight: each channel's maximum over the
    top ``p`` fraction (at least one) of the dark channel's pixels, (N, 1,
    1, 3). Ties go to the lower index, as ``jax.lax.top_k`` breaks them
    (a stable sort), so the same pixels are picked."""
    n = x.shape[1] * x.shape[2]
    top = max(int(n * p), 1)
    flat_dark = dark_channel(x, kernel_size).reshape(x.shape[0], -1)
    idx = torch.sort(flat_dark, dim=-1, descending=True, stable=True).indices[:, :top]
    sel = torch.take_along_dim(x.reshape(x.shape[0], -1, 3), idx[..., None], dim=1)
    return sel.max(dim=1).values[:, None, None, :]


def std_loss(v: torch.Tensor) -> torch.Tensor:
    """StdLoss: the MSE between the channel mean (VALID-cropped) and its
    5x5 box blur."""
    g = v.mean(dim=-1, keepdim=True)
    blur = F.avg_pool2d(g.permute(0, 3, 1, 2), 5, stride=1).permute(0, 2, 3, 1)
    return ((g[:, 2:-2, 2:-2] - blur) ** 2).mean()


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def zid_forward_loss(model: Model, datapoint: dict) -> tuple:
    """Composition (against the J-net's own output, as upstream), KL, StdLoss
    of mask and ambient, the dark channel toward 0, and the ambient toward
    the (detached) airlight."""
    lq = datapoint["image"]
    out = model.apply({"image": lq}, training=True)
    image, mask, ambient = out["image"], out["mask"], out["ambient"]
    loss = _mse(mask * image + (1 - mask) * ambient, image)
    loss = loss + out["vae_kl"]
    loss = loss + 0.005 * std_loss(mask) + 0.1 * std_loss(ambient)
    dcp = image.min(dim=-1).values
    loss = loss + _mse(dcp, torch.zeros_like(dcp)) - 0.05
    prior = atmospheric_prior(lq).detach()
    loss = loss + _mse(ambient, prior * torch.ones_like(ambient))
    return loss, out


@MODELS.register(name="zid", arch="zid", tasks=(Task.DEHAZE,),
                 schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE))
def zid(image_size=(128, 128), generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="zid", arch="zid",
        module=ZIDModule(size=tuple(image_size), generator=generator),
        tasks=(Task.DEHAZE,), schemes=(Scheme.UNSUPERVISED, Scheme.ZERO_REFERENCE),
        forward_loss_fn=zid_forward_loss,
        required_inputs=("image",),
        instance_steps=500, instance_lr=1e-3, size_divisor=32,
    )
