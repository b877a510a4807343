"""MPRNet: multi-stage progressive restoration.

Port of ``enhax/models/multitask/mprnet.py``. Stage 1 runs a 3-level UNet
of channel attention blocks (CAB) on the four quadrants of the image, stage
2 on its two halves (the features concatenated back along W, then H), stage
3 (ORSNet: three original-resolution blocks of ``num_cab`` CABs) on the
whole image; supervised attention modules (SAM) bridge the stages and
cross-stage feature fusion (CSFF) feeds stage 1's features into stage 2's
encoder. Down- and upsampling are a half-pixel bilinear resize of 0.5x /
2x (no antialias, the JAX package's ``jax.image.resize``) and a 1x1 conv.
Outputs ``enhanced``, ``stage1`` and ``stage2``; the loss is
``edge_charbonnier_loss`` (edge weight 0.05) of each against ``ref_image``,
summed.

Images are NHWC throughout. The parameter names are the reference torch
code's (mprnet.py): ``shallow_feat{1,2,3}.{0,1}``, ``stage{1,2}_encoder.
encoder_level{1,2,3}.j``, ``stage{1,2}_decoder.decoder_level{1,2,3}.j``,
``.skip_attn{1,2}``, ``down12.down.1``, ``up21.up.1``, ``csff_{enc,dec}
{1,2,3}``, ``stage3_orsnet.orb{1,2,3}.body.j``, ``up_enc2.{0,1}.up.1``,
``conv_{enc,dec}{1,2,3}``, ``sam12``, ``sam23``, ``concat12``,
``concat23``, ``tail``; in a CAB ``body.{0,1,2}`` (conv, PReLU, conv) and
``CA.conv_du.{0,2}``. The reference shares one PReLU across every CAB, so
its state dict repeats that tensor under each CAB's ``body.1.weight``; here,
as in the JAX package, each CAB holds its own, and a released ``.pth``
loads as it is. No conv has a bias. No kernel: the convs go to cuDNN.
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import LOSSES, MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import NHWCConv2d, PWConv, lecun_normal_
from enhax_torch.ops.resize import resize

__all__ = ["CAB", "MPRNetModule", "SAM"]


def _conv3(cin: int, cout: int) -> NHWCConv2d:
    return NHWCConv2d(cin, cout, 3, padding=1, bias=False)


def _conv1(cin: int, cout: int) -> PWConv:
    return PWConv(cin, cout, bias=False)


class _Bilinear(nn.Module):
    """The half-pixel bilinear resize by ``scale`` (int(H * scale))."""

    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        return resize(x, (int(h * self.scale), int(w * self.scale)), method="bilinear")


class _PReLU(nn.Module):
    """PReLU with one slope (0.25 at init): where(y >= 0, y, a * y)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return torch.where(y >= 0, y, self.weight * y)


class _CALayer(nn.Module):
    def __init__(self, n: int, reduction: int):
        super().__init__()
        self.conv_du = nn.Sequential(_conv1(n, n // reduction), nn.ReLU(),
                                     _conv1(n // reduction, n), nn.Sigmoid())

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.conv_du(y.mean(dim=(-3, -2), keepdim=True))


class CAB(nn.Module):
    """Channel attention block: conv, PReLU, conv, channel attention, skip."""

    def __init__(self, n: int, reduction: int = 4):
        super().__init__()
        self.body = nn.Sequential(_conv3(n, n), _PReLU(), _conv3(n, n))
        self.CA = _CALayer(n, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CA(self.body(x)) + x


class SAM(nn.Module):
    """Supervised attention module (kernel 1): the stage's image, and its
    features gated by that image."""

    def __init__(self, n: int):
        super().__init__()
        self.conv1 = _conv1(n, n)
        self.conv2 = _conv1(n, 3)
        self.conv3 = _conv1(3, n)

    def forward(self, x: torch.Tensor, x_img: torch.Tensor) -> tuple:
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class _Resample(nn.Module):
    """A bilinear resize by ``scale``, then a 1x1 conv, under ``down``
    (scale < 1) or ``up``."""

    def __init__(self, cin: int, cout: int, scale: float):
        super().__init__()
        self.attr = "down" if scale < 1 else "up"
        self.add_module(self.attr, nn.Sequential(_Bilinear(scale), _conv1(cin, cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.attr)(x)


def _cabs(n: int, count: int, reduction: int) -> nn.Sequential:
    return nn.Sequential(*(CAB(n, reduction) for _ in range(count)))


class _Encoder(nn.Module):
    def __init__(self, n: int, s: int, reduction: int, csff: bool):
        super().__init__()
        dims = (n, n + s, n + 2 * s)
        for lvl, d in enumerate(dims, 1):
            self.add_module(f"encoder_level{lvl}", _cabs(d, 2, reduction))
            if csff:
                self.add_module(f"csff_enc{lvl}", _conv1(d, d))
                self.add_module(f"csff_dec{lvl}", _conv1(d, d))
        self.down12 = _Resample(dims[0], dims[1], 0.5)
        self.down23 = _Resample(dims[1], dims[2], 0.5)
        self.csff = csff

    def forward(self, x: torch.Tensor, enc_outs=None, dec_outs=None) -> list:
        outs = []
        for lvl, down in enumerate((self.down12, self.down23, None)):
            x = getattr(self, f"encoder_level{lvl + 1}")(x)
            if self.csff and enc_outs is not None:
                x = (x + getattr(self, f"csff_enc{lvl + 1}")(enc_outs[lvl])
                     + getattr(self, f"csff_dec{lvl + 1}")(dec_outs[lvl]))
            outs.append(x)
            if down is not None:
                x = down(x)
        return outs


class _Decoder(nn.Module):
    def __init__(self, n: int, s: int, reduction: int):
        super().__init__()
        dims = (n, n + s, n + 2 * s)
        for lvl, d in enumerate(dims, 1):
            self.add_module(f"decoder_level{lvl}", _cabs(d, 2, reduction))
        self.skip_attn1 = CAB(dims[0], reduction)
        self.skip_attn2 = CAB(dims[1], reduction)
        self.up21 = _Resample(dims[1], dims[0], 2.0)
        self.up32 = _Resample(dims[2], dims[1], 2.0)

    def forward(self, encs: list) -> list:
        enc1, enc2, enc3 = encs
        dec3 = self.decoder_level3(enc3)
        dec2 = self.decoder_level2(self.up32(dec3) + self.skip_attn2(enc2))
        dec1 = self.decoder_level1(self.up21(dec2) + self.skip_attn1(enc1))
        return [dec1, dec2, dec3]


class _ORB(nn.Module):
    """``num_cab`` CABs and a 3x3 conv, with a skip."""

    def __init__(self, n: int, reduction: int, num_cab: int):
        super().__init__()
        self.body = nn.Sequential(*(CAB(n, reduction) for _ in range(num_cab)), _conv3(n, n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class _ORSNet(nn.Module):
    def __init__(self, n: int, s_ors: int, s_unet: int, num_cab: int, reduction: int):
        super().__init__()
        co = n + s_ors
        for i in (1, 2, 3):
            self.add_module(f"orb{i}", _ORB(co, reduction, num_cab))
        self.up_enc1 = _Resample(n + s_unet, n, 2.0)
        self.up_dec1 = _Resample(n + s_unet, n, 2.0)
        self.up_enc2 = nn.Sequential(_Resample(n + 2 * s_unet, n + s_unet, 2.0),
                                     _Resample(n + s_unet, n, 2.0))
        self.up_dec2 = nn.Sequential(_Resample(n + 2 * s_unet, n + s_unet, 2.0),
                                     _Resample(n + s_unet, n, 2.0))
        for i in (1, 2, 3):
            self.add_module(f"conv_enc{i}", _conv1(n, co))
            self.add_module(f"conv_dec{i}", _conv1(n, co))

    def forward(self, x: torch.Tensor, encs: list, decs: list) -> torch.Tensor:
        x = self.orb1(x)
        x = x + self.conv_enc1(encs[0]) + self.conv_dec1(decs[0])
        x = self.orb2(x)
        x = x + self.conv_enc2(self.up_enc1(encs[1])) + self.conv_dec2(self.up_dec1(decs[1]))
        x = self.orb3(x)
        return x + self.conv_enc3(self.up_enc2(encs[2])) + self.conv_dec3(self.up_dec2(decs[2]))


class MPRNetModule(nn.Module):
    def __init__(self, channels: int = 96, s_unet: int = 48, s_ors: int = 32, num_cab: int = 8,
                 reduction: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        c = channels
        for i in (1, 2, 3):
            self.add_module(f"shallow_feat{i}", nn.Sequential(_conv3(3, c), CAB(c, reduction)))
        self.stage1_encoder = _Encoder(c, s_unet, reduction, csff=False)
        self.stage1_decoder = _Decoder(c, s_unet, reduction)
        self.stage2_encoder = _Encoder(c, s_unet, reduction, csff=True)
        self.stage2_decoder = _Decoder(c, s_unet, reduction)
        self.stage3_orsnet = _ORSNet(c, s_ors, s_unet, num_cab, reduction)
        self.sam12 = SAM(c)
        self.sam23 = SAM(c)
        self.concat12 = _conv3(2 * c, c)
        self.concat23 = _conv3(2 * c, c + s_ors)
        self.tail = _conv3(c + s_ors, 3)
        # flax's default: lecun normal kernels; the PReLU slopes keep 0.25
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)

    def forward(self, x: torch.Tensor) -> dict:
        h, w = x.shape[-3], x.shape[-2]
        top, bot = x[:, :h // 2], x[:, h // 2:]
        quads = (top[:, :, :w // 2], top[:, :, w // 2:], bot[:, :, :w // 2], bot[:, :, w // 2:])
        feats1 = [self.stage1_encoder(self.shallow_feat1(q)) for q in quads]
        feat1_top = [torch.cat(kv, dim=2) for kv in zip(feats1[0], feats1[1])]
        feat1_bot = [torch.cat(kv, dim=2) for kv in zip(feats1[2], feats1[3])]
        res1_top = self.stage1_decoder(feat1_top)
        res1_bot = self.stage1_decoder(feat1_bot)
        top_feats, img1_top = self.sam12(res1_top[0], top)
        bot_feats, img1_bot = self.sam12(res1_bot[0], bot)
        stage1_img = torch.cat([img1_top, img1_bot], dim=1)

        x2top = self.concat12(torch.cat([self.shallow_feat2(top), top_feats], dim=-1))
        x2bot = self.concat12(torch.cat([self.shallow_feat2(bot), bot_feats], dim=-1))
        feat2_top = self.stage2_encoder(x2top, feat1_top, res1_top)
        feat2_bot = self.stage2_encoder(x2bot, feat1_bot, res1_bot)
        feat2 = [torch.cat(kv, dim=1) for kv in zip(feat2_top, feat2_bot)]
        res2 = self.stage2_decoder(feat2)
        x3_feats, stage2_img = self.sam23(res2[0], x)

        x3 = self.concat23(torch.cat([self.shallow_feat3(x), x3_feats], dim=-1))
        x3 = self.stage3_orsnet(x3, feat2, res2)
        return {"enhanced": self.tail(x3) + x, "stage1": stage1_img, "stage2": stage2_img}


def _mprnet_loss():
    """``edge_charbonnier_loss`` summed over the three stages' images."""
    edge_char = LOSSES.build("edge_charbonnier_loss", edge_loss_weight=0.05)

    def fn(outputs, datapoint):
        t = datapoint["ref_image"]
        return (edge_char(outputs["enhanced"], t) + edge_char(outputs["stage1"], t)
                + edge_char(outputs["stage2"], t))
    return fn


@MODELS.register(name="mprnet", arch="mprnet",
                 tasks=(Task.DEBLUR, Task.DENOISE, Task.DERAIN, Task.DESNOW),
                 schemes=(Scheme.SUPERVISED,))
def mprnet(channels: int = 96, s_unet: int = 48, s_ors: int = 32, num_cab: int = 8,
           reduction: int = 4, generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="mprnet", arch="mprnet",
        module=MPRNetModule(channels=channels, s_unet=s_unet, s_ors=s_ors, num_cab=num_cab,
                            reduction=reduction, generator=generator),
        tasks=(Task.DEBLUR, Task.DENOISE, Task.DERAIN, Task.DESNOW),
        schemes=(Scheme.SUPERVISED,),
        loss_fn=_mprnet_loss(),
        required_inputs=("image",),
        size_divisor=16,
    )
