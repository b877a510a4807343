"""Uformer: a U-shaped window-attention transformer for restoration.

Port of ``enhax/models/multitask/uformer.py``: LeWin blocks (LayerNorm ->
window MSA with a relative position bias and split q / kv projections ->
LayerNorm -> LeFF: linear, GELU, depthwise 3x3, GELU, linear), shifted
windows on every odd block, in a 4-level UNet with 4x4 stride-2 conv
downsampling, 2x2 stride-2 transposed-conv upsampling, skip concats, a 3x3
input projection with LeakyReLU(0.01), a 3x3 output projection and a global
residual. The decoder blocks of the t/s/b/noshift/fastleff variants add a
learned per-window modulator to their tokens (``uformer_re`` only where
asked). A block whose map is no larger than its window drops the shift and
shrinks the window to the map; its bias table and modulator are then built
for the smaller window (``input_resolution``), as the reference builds them.

Images are NHWC at the module boundary and inside. The parameter names are
the reference torch code's (uformer.py): ``input_proj.proj.0``,
``encoderlayer_{i}.blocks.j``, ``downsample_{i}.conv.0``, ``conv.blocks.j``,
``upsample_{i}.deconv.0``, ``decoderlayer_{i}.blocks.j`` (decoder i is the
JAX package's level 3 - i), ``output_proj.proj.0``; inside a block
``norm1``, ``attn.{qkv.to_q,qkv.to_kv,relative_position_bias_table,proj}``,
``modulator``, ``norm2``, ``mlp.{linear1.0,dwconv.0,linear2.0}``. A
released ``.pth`` loads with ``load_state_dict`` as it is.

No kernel: the JAX package computes the model in XLA; the window products
are ``torch.matmul``. The loss is the Charbonnier of ``enhanced`` against
``ref_image``; ``size_divisor`` is 128 (four downsamplings of window 8).
"""

from __future__ import annotations

import torch
from torch import nn

from enhax_torch.constants import MODELS, Scheme, Task
from enhax_torch.models.base import Model
from enhax_torch.nn.layers import (DWConv3x3, NHWCConv2d, WindowAttention, gelu_erf,
                                   lecun_normal_, make_shift_attn_mask)
from enhax_torch.nn.losses import charbonnier_loss

__all__ = ["LeFF", "LeWinBlock", "UformerModule"]


class _GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_erf(x)


class LeFF(nn.Module):
    """Locally-enhanced feed-forward: linear -> GELU -> dw 3x3 -> GELU ->
    linear (exact GELU), on NHWC maps."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        hidden = dim * mult
        self.linear1 = nn.Sequential(nn.Linear(dim, hidden), _GELU())
        self.dwconv = nn.Sequential(DWConv3x3(hidden), _GELU())
        self.linear2 = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.dwconv(self.linear1(x)))


class LeWinBlock(nn.Module):
    """x + W-MSA(LN(x)), then + LeFF(LN(.)). ``shift`` is the roll of a
    shifted block (ws // 2); ``input_resolution`` (h, w), where given and
    no larger than the window, builds the block as it runs there: the
    window shrunk to min(h, w) and no shift."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift: int = 0,
                 mult: int = 4, use_modulator: bool = False, input_resolution=None):
        super().__init__()
        if input_resolution is not None and min(input_resolution) <= window_size:
            window_size, shift = min(input_resolution), 0
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = LeFF(dim, mult)
        self.modulator = nn.Embedding(window_size ** 2, dim) if use_modulator else None
        self._masks: dict = {}

    def _mask(self, h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
        key = (h, w, ws, shift, device)
        if key not in self._masks:
            self._masks[key] = make_shift_attn_mask(h, w, ws, shift, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        ws, shift = self.window_size, self.shift
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if ws != self.window_size:
            raise ValueError(f"a {h}x{w} map needs a window of {ws}, but the block was built "
                             f"for {self.window_size}: pass input_resolution=({h}, {w})")
        if h % ws or w % ws:
            raise ValueError(f"a {h}x{w} map is not a whole number of {ws}x{ws} windows")
        mask = self._mask(h, w, ws, shift, x.device) if shift else None
        mod = self.modulator.weight if self.modulator is not None else None
        x = x + self.attn(self.norm1(x), mask, shift, modulator=mod)
        return x + self.mlp(self.norm2(x))


class _Stage(nn.Module):
    """A run of LeWin blocks under the reference name ``blocks``; shifted
    on every odd block where ``use_shift``."""

    def __init__(self, dim: int, heads: int, depth: int, window_size: int, use_shift: bool,
                 use_modulator: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            LeWinBlock(dim, heads, window_size,
                       shift=window_size // 2 if use_shift and j % 2 == 1 else 0,
                       use_modulator=use_modulator)
            for j in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class _Proj(nn.Module):
    """``proj``: a 3x3 conv, with a LeakyReLU(0.01) after it at the input."""

    def __init__(self, cin: int, cout: int, act: bool):
        super().__init__()
        layers = [NHWCConv2d(cin, cout, 3, padding=1)]
        if act:
            layers.append(nn.LeakyReLU(0.01))
        self.proj = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class _NHWCConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(NHWCConv2d(cin, cout, 4, stride=2, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = nn.Sequential(_NHWCConvTranspose2d(cin, cout, 2, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(x)


class UformerModule(nn.Module):
    """``depths`` and ``num_heads``: enc0..3, the middle, dec3..0."""

    def __init__(self, dim: int = 32, depths=(2, 2, 2, 2, 2, 2, 2, 2, 2),
                 num_heads=(1, 2, 4, 8, 16, 16, 8, 4, 2), window_size: int = 8,
                 use_shift: bool = True, modulator: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, ws = dim, window_size
        self.input_proj = _Proj(3, d, act=True)
        for lvl in range(4):
            setattr(self, f"encoderlayer_{lvl}",
                    _Stage(d * 2 ** lvl, num_heads[lvl], depths[lvl], ws, use_shift, False))
            setattr(self, f"downsample_{lvl}", _Down(d * 2 ** lvl, d * 2 ** (lvl + 1)))
        self.conv = _Stage(d * 16, num_heads[4], depths[4], ws, use_shift, False)
        for i, lvl in enumerate(reversed(range(4))):
            cin = d * 16 if lvl == 3 else d * 2 ** (lvl + 2)
            setattr(self, f"upsample_{i}", _Up(cin, d * 2 ** lvl))
            setattr(self, f"decoderlayer_{i}",
                    _Stage(d * 2 ** (lvl + 1), num_heads[5 + i], depths[5 + i], ws, use_shift,
                           modulator))
        self.output_proj = _Proj(2 * d, 3, act=False)
        # flax's defaults: lecun normal kernels and zero biases; the bias
        # table and the modulator normal(0.02); LayerNorms ones and zeros
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
                elif isinstance(m, nn.Embedding):
                    m.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        y = self.input_proj(x)
        skips = []
        for lvl in range(4):
            y = getattr(self, f"encoderlayer_{lvl}")(y)
            skips.append(y)
            y = getattr(self, f"downsample_{lvl}")(y)
        y = self.conv(y)
        for i, lvl in enumerate(reversed(range(4))):
            y = torch.cat([getattr(self, f"upsample_{i}")(y), skips[lvl]], dim=-1)
            y = getattr(self, f"decoderlayer_{i}")(y)
        return {"enhanced": self.output_proj(y) + x}


def _charb_loss():
    c = charbonnier_loss()

    def fn(outputs, datapoint):
        return c(outputs["enhanced"], datapoint["ref_image"])
    return fn


def _make_uformer(name: str, dim: int, depths, use_shift: bool = True, modulator: bool = True,
                  generator: torch.Generator | None = None) -> Model:
    return Model(
        name=name, arch="uformer",
        module=UformerModule(dim=dim, depths=tuple(depths), use_shift=use_shift,
                             modulator=modulator, generator=generator),
        tasks=(Task.DENOISE, Task.DEBLUR, Task.DERAIN),
        schemes=(Scheme.SUPERVISED,),
        loss_fn=_charb_loss(),
        required_inputs=("image",),
        size_divisor=128,
    )


@MODELS.register(name="uformer_re", arch="uformer", aliases=["uformer"],
                 tasks=(Task.DENOISE, Task.DEBLUR), schemes=(Scheme.SUPERVISED,))
def uformer_re(dim: int = 32, modulator: bool = False, depths=(2, 2, 2, 2, 2, 2, 2, 2, 2),
               use_shift: bool = True, generator: torch.Generator | None = None,
               **kwargs) -> Model:
    return _make_uformer("uformer_re", dim, depths, use_shift=use_shift, modulator=modulator,
                         generator=generator)


@MODELS.register(name="uformer_t", arch="uformer", tasks=(Task.DENOISE,),
                 schemes=(Scheme.SUPERVISED,))
def uformer_t(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make_uformer("uformer_t", 16, (2,) * 9, generator=generator)


@MODELS.register(name="uformer_s", arch="uformer", tasks=(Task.DENOISE,),
                 schemes=(Scheme.SUPERVISED,))
def uformer_s(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make_uformer("uformer_s", 32, (2,) * 9, generator=generator)


@MODELS.register(name="uformer_b", arch="uformer", tasks=(Task.DENOISE,),
                 schemes=(Scheme.SUPERVISED,))
def uformer_b(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make_uformer("uformer_b", 32, (1, 2, 8, 8, 2, 8, 8, 2, 1), generator=generator)


@MODELS.register(name="uformer_noshift", arch="uformer", tasks=(Task.DENOISE,),
                 schemes=(Scheme.SUPERVISED,))
def uformer_noshift(generator: torch.Generator | None = None, **kwargs) -> Model:
    return _make_uformer("uformer_noshift", 32, (2,) * 9, use_shift=False, generator=generator)


@MODELS.register(name="uformer_fastleff", arch="uformer", tasks=(Task.DENOISE,),
                 schemes=(Scheme.SUPERVISED,))
def uformer_fastleff(generator: torch.Generator | None = None, **kwargs) -> Model:
    # the reference's FastLeFF computes what LeFF does: one implementation
    return _make_uformer("uformer_fastleff", 32, (1, 2, 8, 8, 2, 8, 8, 2, 1),
                         generator=generator)
