"""AirNet: all-in-one image restoration with degradation-guided DCNs.

Port of ``enhax/models/multitask/airnet.py``:

  * the degradation encoder: of the reference's contrastive (MoCo) encoder
    only the query encoder's first ResBlock reaches the restorer, the
    full-resolution degradation map ``inter`` (conv, BatchNorm, LeakyReLU,
    conv, BatchNorm, and a 1x1 conv and BatchNorm shortcut);
  * the restorer (DGRN): a head conv, ``n_groups`` groups of ``n_blocks``
    degradation-guided blocks and a conv each, a conv and the global skip,
    a tail conv. A block (DGB) runs two degradation-guided modules (DGM:
    a modulated deformable conv whose offsets and masks a conv predicts
    from cat(x, inter), plus an SFT layer, a FiLM from ``inter``) between
    3x3 convs.

Outputs ``enhanced`` and ``degradation`` (``inter``); the loss is the L1
of ``enhanced`` against ``ref_image`` (``image`` where there is none): the
contrastive training of the reference is a supervised L1 here, as in the
JAX package.

The BatchNorms (``nn.layers.BatchNorm``) normalise with their running
statistics, but in the forward ``train=True`` passes, which the Trainer
takes on a float32 step (``Model.apply(..., batch_stats=True)``): then with
the batch's, updating the running ones as flax does.

The DCN is ``nn/deform.py``'s plain PyTorch (the JAX package's XLA
gathers); the model has no kernel. Initialised as the JAX package's:
lecun normal convs with zero biases, ``conv_offset_mask`` all zeros (every
offset 0 and mask 0.5 at init), the DCN weight U(+-1/sqrt(C k^2)).

Images are NHWC throughout. The parameter names are the reference torch
code's (airnet/net): ``E.E.encoder_q.E_pre.{backbone.{0,1,3,4},
shortcut.{0,1}}``, ``R.head.0``, ``R.body.{g}.body.{b}.{dgm1,conv1,dgm2,
conv2}``, ``R.body.{g}.body.{n_blocks}``, ``R.body.{n_groups}``,
``R.tail.0``; in a DGM ``dcn.{weight,conv_offset_mask}`` and
``sft.conv_{gamma,beta}.{0,2}``. A released checkpoint's other encoder
entries (the rest of the query and key encoders, the queue) are dropped on
load: the restorer reads none of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.deform import modulated_deform_conv2d
from enhax_torch.nn.layers import BatchNorm, NHWCConv2d, PWConv, lecun_normal_

__all__ = ["AirNetModule", "DCN"]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv3(cin: int, cout: int, bias: bool = True, stride: int = 1) -> NHWCConv2d:
    return NHWCConv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class _ResBlock(nn.Module):
    """conv-BN-lrelu-conv-BN plus a 1x1 conv-BN shortcut, lrelu (no biases)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.backbone = nn.Sequential(_conv3(cin, cout, False, stride), BatchNorm(cout),
                                      nn.LeakyReLU(0.1), _conv3(cout, cout, False),
                                      BatchNorm(cout))
        self.shortcut = nn.Sequential(NHWCConv2d(cin, cout, 1, stride=stride, bias=False),
                                      BatchNorm(cout))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bb, sc = self.backbone, self.shortcut
        y = _lrelu(bb[1](bb[0](x), train))
        y = bb[4](bb[3](y), train)
        return _lrelu(y + sc[1](sc[0](x), train))


class DCN(nn.Module):
    """DCN_layer without bias: offsets and masks from a k x k conv of
    cat(x, inter) (its first 2k^2 channels the offsets, torch's cat((o1,
    o2)) read interleaved; the last k^2 the masks' logits)."""

    def __init__(self, channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(features, channels, kernel, kernel))
        self.conv_offset_mask = NHWCConv2d(2 * channels, 3 * kernel * kernel, kernel,
                                           padding=kernel // 2)

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        kk = self.kernel * self.kernel
        om = self.conv_offset_mask(torch.cat([x, inter], dim=-1))
        return modulated_deform_conv2d(x, om[..., :2 * kk], torch.sigmoid(om[..., 2 * kk:]),
                                       self.weight)


class _SFT(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.conv_gamma = nn.Sequential(PWConv(n, n, bias=False), nn.LeakyReLU(0.1),
                                        PWConv(n, n, bias=False))
        self.conv_beta = nn.Sequential(PWConv(n, n, bias=False), nn.LeakyReLU(0.1),
                                       PWConv(n, n, bias=False))

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        return x * self.conv_gamma(inter) + self.conv_beta(inter)


class _DGM(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.sft = _SFT(n)
        self.dcn = DCN(n, n)

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        return x + (self.dcn(x, inter) + self.sft(x, inter))


class _DGB(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.dgm1 = _DGM(n)
        self.dgm2 = _DGM(n)
        self.conv1 = _conv3(n, n)
        self.conv2 = _conv3(n, n)

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        out = _lrelu(self.dgm1(x, inter))
        out = _lrelu(self.conv1(out))
        out = _lrelu(self.dgm2(out, inter))
        return self.conv2(out) + x


class _DGG(nn.Module):
    def __init__(self, n: int, n_blocks: int):
        super().__init__()
        self.body = nn.ModuleList([*(_DGB(n) for _ in range(n_blocks)), _conv3(n, n)])

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        res = x
        for block in self.body[:-1]:
            res = block(res, inter)
        return self.body[-1](res) + x


class _DGRN(nn.Module):
    def __init__(self, n: int, n_groups: int, n_blocks: int):
        super().__init__()
        self.head = nn.Sequential(_conv3(3, n))
        self.body = nn.ModuleList([*(_DGG(n, n_blocks) for _ in range(n_groups)), _conv3(n, n)])
        self.tail = nn.Sequential(_conv3(n, 3))

    def forward(self, x: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
        y = self.head(x)
        res = y
        for group in self.body[:-1]:
            res = group(res, inter)
        return self.tail(self.body[-1](res) + y)


class AirNetModule(nn.Module):
    def __init__(self, n_feats: int = 64, n_groups: int = 5, n_blocks: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        # the reference's nesting: E (CBDE) . E (MoCo) . encoder_q . E_pre
        self.E = nn.Module()
        self.E.E = nn.Module()
        self.E.E.encoder_q = nn.Module()
        self.E.E.encoder_q.E_pre = _ResBlock(3, n_feats)
        self.R = _DGRN(n_feats, n_groups, n_blocks)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
            # after the loop above, which visits the offset convs too
            for m in self.modules():
                if isinstance(m, DCN):
                    stdv = 1.0 / (m.weight.shape[1] * m.kernel * m.kernel) ** 0.5
                    m.weight.uniform_(-stdv, stdv, generator=generator)
                    m.conv_offset_mask.weight.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> dict:
        inter = self.E.E.encoder_q.E_pre(x, train)
        return {"enhanced": self.R(x, inter), "degradation": inter}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        own = prefix + "E.E.encoder_q.E_pre."
        for key in [k for k in state_dict
                    if k.startswith(prefix + "E.") and not k.startswith(own)]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def airnet_loss():
    def fn(outputs, datapoint):
        target = datapoint.get("ref_image", datapoint["image"])
        return (outputs["enhanced"] - target).abs().mean()
    return fn


@MODELS.register(name="airnet", arch="airnet",
                 tasks=(Task.DENOISE, Task.DERAIN, Task.DEHAZE),
                 schemes=(Scheme.SUPERVISED,))
def airnet(n_feats: int = 64, n_groups: int = 5, n_blocks: int = 5,
           generator: torch.Generator | None = None, **kwargs) -> Model:
    return Model(
        name="airnet", arch="airnet",
        module=AirNetModule(n_feats=n_feats, n_groups=n_groups, n_blocks=n_blocks,
                            generator=generator),
        tasks=(Task.DENOISE, Task.DERAIN, Task.DEHAZE),
        schemes=(Scheme.SUPERVISED,),
        loss_fn=airnet_loss(),
        required_inputs=("image",),
        size_divisor=1,
    )
