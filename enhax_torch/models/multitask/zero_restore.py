"""Zero-Restore: zero-shot restoration by perturbing the Koschmieder model,
fitted to each image.

Port of ``enhax/models/multitask/zero_restore.py``:
  * shared: reflect-padded convs (no bias) + GroupNorm(8) + ReLU
    (``GNConv``); ``InConv``, ONE shared 7x7 stride-4 conv run on each RGB
    channel (the channels folded into the batch) and reduced across them,
    max for LLIE and min (the dark channel) for dehaze and UIE
    (``torch.amax``/``torch.amin``, which split a tie's gradient evenly as
    JAX's reductions do); ``SKConv``, three scales (1, 1/2, 1/4) through
    the shared InConv with align-corners resizes and a softmax attention
    over the scales; enhanced = (I - (1 - t) A) / t.
  * LLIE (``Estimation``): a spatial atmospheric map, GNConv(x) times the
    upsampled trunk, a DoubleConv, a 1-channel conv, sigmoid; a 1-channel
    transmission.
  * dehaze / UIE (``EstimationGlobal``): a 9x9 stride-4 + 3x3 GNConv pair
    times the trunk, a VALID max pool (15, stride 7), a DoubleConv, the
    spatial mean and a 3-way Dense (no bias), sigmoid: one RGB atmospheric
    vector an image; UIE's transmission has 3 channels.
  * the loss (``zero_restore_forward_loss``): two forwards a step, the
    second on ``0.9 image + 0.1 atm`` (``atm`` not detached), perturbation
    consistency on t and A, out-of-range penalties (LLIE's blue channel
    x10; dehaze / UIE unweighted plus 1000 x colour constancy), 0.001 TV.

Reflection padding follows ``jnp.pad(mode="reflect")``, which reflects an
axis of any length and repeats one of length 1 (the dehaze trunk's pooled
map is 1x1 at 64x64): ``F.pad(mode="reflect")`` where the pad is shorter
than the axis, the same indices gathered otherwise. The modules take NHWC
images, run NCHW inside, and keep the JAX package's parameter names
(``estimation.in_conv.in_conv.conv.conv``, ``...gn``, ``fc``, ``fcs0``,
...). The registry functions ignore their keywords as the JAX package's do
(the configs' ``num_channels: 64`` is the default). 1000 (LLIE) or 10000
Adam steps at lr 1e-3 an image through ``Predictor``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.inr import dense
from enhax_torch.nn.layers import flax_conv2d
from enhax_torch.nn.losses import color_constancy_loss, total_variation_loss


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    """The source indices of ``jnp.pad(mode="reflect")`` along an axis of
    length n padded by p on each side (period 2 (n - 1); all 0 for n = 1)."""
    idx = torch.arange(-p, n + p, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    m = idx.remainder(2 * (n - 1))
    return torch.where(m >= n, 2 * (n - 1) - m, m)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Pad the last two axes of an NCHW map by p, as ``jnp.pad`` reflects."""
    h, w = x.shape[-2:]
    if p == 0:
        return x
    if p < h and p < w:
        return F.pad(x, (p,) * 4, mode="reflect")
    x = x.index_select(-2, _reflect_index(h, p, x.device))
    return x.index_select(-1, _reflect_index(w, p, x.device))


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    """``resize_align_corners`` on an NCHW map."""
    hw = (int(hw[0]), int(hw[1]))
    if tuple(x.shape[-2:]) == hw:
        return x
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


class GNConv(nn.Module):
    """conv (reflect padded, no bias) + GroupNorm(8, eps 1e-5) + ReLU."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pad = kernel // 2
        self.conv = flax_conv2d(in_channels, features, kernel, stride, padding=0, bias=False,
                                generator=generator)
        self.gn = nn.GroupNorm(8, features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(reflect_pad(x, self.pad))))


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c1 = GNConv(in_channels, features, generator=generator)
        self.c2 = GNConv(features, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class InDoubleConvDown(nn.Module):
    """The dehaze / UIE ``conv_a1``: a 9x9 stride-4 and a 3x3 GNConv."""

    def __init__(self, in_channels: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c1 = GNConv(in_channels, features, 9, 4, generator=generator)
        self.c2 = GNConv(features, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class InConv(nn.Module):
    """One 7x7 stride-4 GNConv shared by the three channels, reduced across
    them (max or min), then a 3x3 GNConv."""

    def __init__(self, features: int = 64, reduce: str = "max",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.reduce = reduce
        self.conv = GNConv(1, features, 7, 4, generator=generator)
        self.convf = GNConv(features, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        feats = self.conv(x.reshape(n * c, 1, h, w))
        feats = feats.reshape(n, c, *feats.shape[1:])
        y = torch.amax(feats, dim=1) if self.reduce == "max" else torch.amin(feats, dim=1)
        return self.convf(y)


class SKConv(nn.Module):
    """Selective-kernel fusion of the shared InConv at scales 1, 1/2, 1/4
    (align-corners resizes), softmax attention over the scales."""

    def __init__(self, features: int = 64, M: int = 3, L: int = 32, reduce: str = "max",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.M = M
        self.in_conv = InConv(features, reduce, generator=generator)
        self.fc = dense(features, L, generator=generator)
        for i in range(M):
            setattr(self, f"fcs{i}", dense(L, features, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2] // 4, x.shape[-1] // 4
        feas = []
        for i in range(self.M):
            if i == 0:
                f = self.in_conv(x)
            else:
                xd = _up(x, (x.shape[-2] // 2 ** i, x.shape[-1] // 2 ** i))
                f = _up(self.in_conv(xd), (h, w))
            feas.append(f)
        feas = torch.stack(feas, dim=1)                      # (N, M, C, h, w)
        fea_s = feas.sum(dim=1).mean(dim=(-2, -1))           # (N, C)
        fea_z = self.fc(fea_s)
        vecs = torch.stack([getattr(self, f"fcs{i}")(fea_z) for i in range(self.M)], dim=1)
        attn = torch.softmax(vecs, dim=1)[..., None, None]   # (N, M, C, 1, 1)
        return (feas * attn).sum(dim=1)


class _ReflectConv(nn.Module):
    """A plain 3x3 reflect-padded conv, no bias (``conv_t2``, ``conv_a3``)."""

    def __init__(self, in_channels: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = flax_conv2d(in_channels, features, 3, padding=0, bias=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad(x, 1))


class Estimation(nn.Module):
    """LLIE: (transmission (N,1,H,W), spatial atmospheric map (N,1,H,W))."""

    def __init__(self, num_channels: int = 64, generator: torch.Generator | None = None):
        super().__init__()
        c, g = num_channels, generator
        self.in_conv = SKConv(c, generator=g)
        self.conv_t1 = DoubleConv(c, c, generator=g)
        self.conv_t2 = _ReflectConv(c, 1, generator=g)
        self.conv_a1 = GNConv(3, c, generator=g)
        self.conv_a2 = DoubleConv(c, c, generator=g)
        self.conv_a3 = _ReflectConv(c, 1, generator=g)

    def forward(self, x: torch.Tensor) -> tuple:
        hw = x.shape[-2:]
        x_min = self.in_conv(x)
        t = self.conv_t2(_up(self.conv_t1(x_min), hw))
        trans = torch.sigmoid(t) + 1e-12
        a = self.conv_a1(x) * _up(x_min, hw)
        atm = torch.sigmoid(self.conv_a3(self.conv_a2(a)))
        return trans, atm


class EstimationGlobal(nn.Module):
    """dehaze / UIE: (transmission (N,T,H,W), atmospheric vector (N,3,1,1));
    ``trans_channels`` T = 1 (dehaze) or 3 (UIE)."""

    def __init__(self, num_channels: int = 64, trans_channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, g = num_channels, generator
        self.in_conv = SKConv(c, reduce="min", generator=g)
        self.conv_t1 = DoubleConv(c, c, generator=g)
        self.conv_t2 = _ReflectConv(c, trans_channels, generator=g)
        self.conv_a1 = InDoubleConvDown(3, c, generator=g)
        self.conv_a2 = DoubleConv(c, c, generator=g)
        self.dense = dense(c, 3, use_bias=False, generator=g)

    def forward(self, x: torch.Tensor) -> tuple:
        x_min = self.in_conv(x)
        t = self.conv_t2(_up(self.conv_t1(x_min), x.shape[-2:]))
        trans = torch.sigmoid(t) + 1e-12
        a = F.max_pool2d(self.conv_a1(x) * x_min, kernel_size=15, stride=7)
        a = self.conv_a2(a).mean(dim=(-2, -1))               # (N, C)
        atm = torch.sigmoid(self.dense(a))
        return trans, atm[:, :, None, None]


class ZeroRestoreModule(nn.Module):
    """NHWC image -> {"trans", "atm", "enhanced"}, each the image's shape."""

    def __init__(self, num_channels: int = 64, variant: str = "llie",
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in ("llie", "dehaze", "uie"):
            raise ValueError(f"variant must be llie, dehaze or uie, got {variant!r}")
        self.variant = variant
        if variant == "llie":
            self.estimation = Estimation(num_channels, generator=generator)
        else:
            self.estimation = EstimationGlobal(
                num_channels, trans_channels=3 if variant == "uie" else 1, generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        trans, atm = self.estimation(x.permute(0, 3, 1, 2))
        trans, atm = trans.permute(0, 2, 3, 1), atm.permute(0, 2, 3, 1)
        enhanced = (x - (1.0 - trans) * atm) / trans
        ones = torch.ones_like(x)
        return {"trans": trans * ones, "atm": atm * ones, "enhanced": enhanced}


def zero_restore_forward_loss(weighted: bool):
    """``forward_loss_fn`` of the three names: LLIE's (``weighted``: the
    blue channel's range penalties x10) or dehaze / UIE's (unweighted, plus
    1000 x colour constancy)."""
    tv = total_variation_loss()
    col = color_constancy_loss()

    def over(v, c):
        return (torch.clamp_min(v[..., c], 1.0) - 1.0).sum()

    def under(v, c):
        return -torch.clamp_max(v[..., c], 0.0).sum()

    def fwd_loss(model: Model, datapoint: dict) -> tuple:
        image = datapoint["image"]
        out = model.apply({"image": image}, training=True)
        p_x = 0.9
        image_x = image * p_x + (1 - p_x) * out["atm"]
        out_x = model.apply({"image": image_x}, training=True)
        e, e_x = out["enhanced"], out_x["enhanced"]
        loss_t = ((out_x["trans"] - p_x * out["trans"]) ** 2).sum()
        loss_a = ((out["atm"] - out_x["atm"]) ** 2).sum()
        if weighted:
            loss_mx = (over(e, 0) + over(e_x, 0)) + (over(e, 1) + over(e_x, 1)) \
                + 10 * (over(e, 2) + over(e_x, 2))
            loss_mn = (under(e, 0) + under(e_x, 0)) + (under(e, 1) + under(e_x, 1)) \
                + 10 * (under(e, 2) + under(e_x, 2))
            loss = loss_t + loss_a + 0.003 * loss_mx + 0.03 * loss_mn + 0.001 * tv(e)
        else:
            loss_mx = sum(over(e, c) + over(e_x, c) for c in range(3))
            loss_mn = sum(under(e, c) + under(e_x, c) for c in range(3))
            loss = loss_t + loss_a + 0.001 * loss_mx + 0.001 * loss_mn \
                + 0.001 * tv(e) + 1000.0 * col(e)
        return loss, out

    return fwd_loss


def _make(name: str, task, variant: str, steps: int,
          generator: torch.Generator | None) -> Model:
    return Model(
        name=name, arch="zero_restore",
        module=ZeroRestoreModule(variant=variant, generator=generator),
        tasks=(task,), schemes=(Scheme.ZERO_REFERENCE, Scheme.ZERO_SHOT),
        forward_loss_fn=zero_restore_forward_loss(variant == "llie"),
        required_inputs=("image",),
        instance_steps=steps, instance_lr=1e-3,
        size_divisor=32,
    )


@MODELS.register(name="zero_restore_llie", arch="zero_restore",
                 tasks=(Task.LLIE,), schemes=(Scheme.ZERO_SHOT,))
def zero_restore_llie(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make("zero_restore_llie", Task.LLIE, "llie", 1000, generator)


@MODELS.register(name="zero_restore_dehaze", arch="zero_restore",
                 tasks=(Task.DEHAZE,), schemes=(Scheme.ZERO_SHOT,))
def zero_restore_dehaze(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make("zero_restore_dehaze", Task.DEHAZE, "dehaze", 10000, generator)


@MODELS.register(name="zero_restore_uie", arch="zero_restore",
                 tasks=(Task.LLIE,), schemes=(Scheme.ZERO_SHOT,))
def zero_restore_uie(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make("zero_restore_uie", Task.LLIE, "uie", 10000, generator)
