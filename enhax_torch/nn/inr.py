"""Implicit neural representation (INR) layers.

Port of ``enhax/nn/inr.py``: the SIREN sine layer, FINER, Gaussian, the
real Gabor (WIRE) layer, ReLU/sigmoid/tanh layers, positional encoding,
the generic ``INRNet`` MLP, coordinate grids and context-window features
(``window_stack``), used by CoLIE and Zero-MIE. Inputs are (...,
features); each layer holds its ``nn.Linear`` as ``linear`` (flax's inner
``Dense_0``).

Every weight is drawn from the caller's ``torch.Generator``: SIREN's
uniform init, flax's lecun-normal default for the other layers, zero
biases (FINER's first layer: uniform in +-``first_bias_scale``). The layers
are built with ``nn.utils.skip_init``, so building one draws nothing from
torch's global generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from enhax_torch.nn.layers import lecun_normal_


@torch.no_grad()
def siren_init_(weight: torch.Tensor, is_first: bool, omega_0: float,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """SIREN's init of a (out, in) weight: U(-1/in, 1/in) for the first
    layer, U(-sqrt(6/in)/omega_0, +) otherwise."""
    fan_in = weight.shape[1]
    bound = 1.0 / fan_in if is_first else math.sqrt(6.0 / fan_in) / omega_0
    return weight.uniform_(-bound, bound, generator=generator)


def dense(in_features: int, out_features: int, use_bias: bool = True,
          generator: torch.Generator | None = None, siren: tuple | None = None) -> nn.Linear:
    """flax's ``nn.Dense`` as an ``nn.Linear``: the weight lecun normal (or
    SIREN's init with ``siren=(is_first, omega_0)``), the bias zero."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features, bias=use_bias)
    if siren is None:
        lecun_normal_(lin.weight, generator)
    else:
        siren_init_(lin.weight, *siren, generator=generator)
    if use_bias:
        nn.init.zeros_(lin.bias)
    return lin


class SineLayer(nn.Module):
    """sin(omega_0 * (Wx + b)) (SIREN)."""

    def __init__(self, in_features: int, features: int, is_first: bool = False,
                 omega_0: float = 30.0, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.omega_0 = omega_0
        self.linear = dense(in_features, features, use_bias, generator, (is_first, omega_0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.omega_0 * self.linear(x))


class FINERLayer(nn.Module):
    """sin(omega_0 * (|y| + 1) * y), y = Wx + b, the scale |y| + 1 taken out
    of the gradient (the JAX package's ``stop_gradient``)."""

    def __init__(self, in_features: int, features: int, is_first: bool = False,
                 omega_0: float = 30.0, first_bias_scale: float | None = None,
                 use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.omega_0 = omega_0
        self.linear = dense(in_features, features, use_bias, generator, (is_first, omega_0))
        if use_bias and is_first and first_bias_scale is not None:
            with torch.no_grad():
                self.linear.bias.uniform_(-first_bias_scale, first_bias_scale,
                                          generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        return torch.sin(self.omega_0 * (y.detach().abs() + 1.0) * y)


class GaussLayer(nn.Module):
    """exp(-(scale * y)^2)."""

    def __init__(self, in_features: int, features: int, scale: float = 10.0,
                 use_bias: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.scale = scale
        self.linear = dense(in_features, features, use_bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(-((self.scale * self.linear(x)) ** 2))


class GaborLayer(nn.Module):
    """Real Gabor (WIRE) layer: cos(omega_0 y) * exp(-(sigma_0 y)^2)."""

    def __init__(self, in_features: int, features: int, is_first: bool = False,
                 omega_0: float = 10.0, sigma_0: float = 40.0, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.omega_0, self.sigma_0 = omega_0, sigma_0
        self.linear = dense(in_features, features, use_bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(x)
        return torch.cos(self.omega_0 * y) * torch.exp(-((self.sigma_0 * y) ** 2))


class _ActivationLayer(nn.Module):
    """A Dense followed by ``act``."""

    act = staticmethod(torch.relu)

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear = dense(in_features, features, use_bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.linear(x))


class ReLULayer(_ActivationLayer):
    act = staticmethod(torch.relu)


class SigmoidLayer(_ActivationLayer):
    act = staticmethod(torch.sigmoid)


class TanhLayer(_ActivationLayer):
    act = staticmethod(torch.tanh)


LAYER_TYPES = {
    "sine": SineLayer, "siren": SineLayer,
    "finer": FINERLayer,
    "gauss": GaussLayer,
    "gabor": GaborLayer, "wire": GaborLayer,
    "relu": ReLULayer,
    "sigmoid": SigmoidLayer,
    "tanh": TanhLayer,
}


def make_layer(layer_type: str, in_features: int, features: int, is_first: bool,
               omega_0: float = 30.0, scale: float = 10.0,
               first_bias_scale: float | None = None,
               generator: torch.Generator | None = None) -> nn.Module:
    """One layer of ``layer_type`` with the keywords its class takes, as
    the JAX package's INR stacks pass them."""
    cls = LAYER_TYPES[layer_type]
    kw = {}
    if cls in (SineLayer, FINERLayer):
        kw = {"is_first": is_first, "omega_0": omega_0}
        if cls is FINERLayer:
            kw["first_bias_scale"] = first_bias_scale
    elif cls is GaussLayer:
        kw = {"scale": scale}
    elif cls is GaborLayer:
        kw = {"is_first": is_first, "omega_0": omega_0, "sigma_0": scale}
    return cls(in_features, features, generator=generator, **kw)


def positional_encoding(x: torch.Tensor, n_freqs: int = 10, logscale: bool = True) -> torch.Tensor:
    """[x, sin(f_0 x), cos(f_0 x), ...] with f_k = 2^k (or evenly spaced
    from 1 to 2^(n-1))."""
    if logscale:
        freqs = [2.0 ** k for k in range(n_freqs)]
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs, dtype=torch.float64).tolist()
    outs = [x]
    for f in freqs:
        fx = x * torch.tensor(f, dtype=x.dtype, device=x.device)
        outs += [torch.sin(fx), torch.cos(fx)]
    return torch.cat(outs, dim=-1)


class INRNet(nn.Module):
    """Generic INR MLP: ``hidden_layers + 1`` layers of ``layer_type``
    (``layer0`` ...), then a plain Dense ``out`` (SIREN's init for the sine
    and FINER types), with an optional final sigmoid or tanh. With
    ``use_pe`` the input is positionally encoded first (PEMLP = ``relu``
    with ``use_pe``). (..., in_features) -> (..., out_features)."""

    def __init__(self, in_features: int = 2, hidden_features: int = 256,
                 hidden_layers: int = 2, out_features: int = 3, layer_type: str = "sine",
                 omega_0: float = 30.0, scale: float = 10.0,
                 first_bias_scale: float | None = None, use_pe: bool = False,
                 n_freqs: int = 10, final_activation: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_pe, self.n_freqs = use_pe, n_freqs
        self.final_activation = final_activation
        n_in = in_features * (1 + 2 * n_freqs) if use_pe else in_features
        self.layers = nn.Sequential()
        for i in range(hidden_layers + 1):
            self.layers.add_module(f"layer{i}", make_layer(
                layer_type, n_in if i == 0 else hidden_features, hidden_features, i == 0,
                omega_0, scale, first_bias_scale, generator))
        siren = (False, omega_0) if LAYER_TYPES[layer_type] in (SineLayer, FINERLayer) else None
        self.out = dense(hidden_features, out_features, True, generator, siren)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_pe:
            x = positional_encoding(x, self.n_freqs)
        x = self.out(self.layers(x))
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.final_activation == "tanh":
            x = torch.tanh(x)
        return x


def coordinate_grid(h: int, w: int, flatten: bool = True, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [-1, 1] (y, x) grid, (H*W, 2) or (H, W, 2)."""
    ys = torch.linspace(-1.0, 1.0, h, device=device, dtype=dtype)
    xs = torch.linspace(-1.0, 1.0, w, device=device, dtype=dtype)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    return grid.reshape(-1, 2) if flatten else grid


def unit_coords(ds: int, n: int, device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The [0, 1]^2 coordinates of a ds x ds grid, channel 0 along W (the
    reference's ``get_coords``): (n, ds, ds, 2)."""
    lin = torch.linspace(0.0, 1.0, ds, device=device, dtype=dtype)
    cx, cy = torch.meshgrid(lin, lin, indexing="xy")
    return torch.stack([cx, cy], dim=-1)[None].expand(n, -1, -1, -1)


def window_stack(x: torch.Tensor, k: int, mode: str) -> torch.Tensor:
    """The k x k neighbourhood of every pixel of channel 0 of (N, H, W, C),
    padded by ``mode`` (``replicate`` or ``reflect``): (N, H, W, k*k), the
    offsets in row-major order."""
    p = k // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x[..., 0][:, None], (p, p, p, p), mode=mode)[:, 0]
    return torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(k) for dx in range(k)],
                       dim=-1)


def context_window_features(image_gray: torch.Tensor, window: int = 1) -> torch.Tensor:
    """Each pixel's (2w+1)^2 neighbourhood (edge-padded), flattened:
    (..., H, W, 1) -> (..., H, W, (2w+1)^2)."""
    lead = image_gray.shape[:-3]
    x = image_gray.reshape(-1, *image_gray.shape[-3:])
    out = window_stack(x, 2 * window + 1, "replicate")
    return out.reshape(*lead, *out.shape[-3:])
