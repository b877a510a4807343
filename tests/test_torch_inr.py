"""Port parity on the CPU: the INR layers (``enhax_torch/nn/inr.py``)
against ``enhax/nn/inr.py``.

Every layer type's output and its gradients (input, kernel, bias) with the
JAX layer's weights, FINER's scale out of the gradient, positional
encoding, ``INRNet`` over layer types with and without encoding and final
activations, the coordinate grid and context windows, and SIREN's init
bounds drawn from the caller's generator. Tolerance 1e-5 x max(1,
max|ref|); FINER with its first-layer bias (sine arguments in the
thousands, where a float32 step is ~1e-3) against the JAX layer in
float64, within max(1e-5, 4 x the JAX layer's own float32 gap).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.nn import inr as jinr
from enhax_torch.nn import inr
from torch_instance_parity import assert_close, assert_witnessed, flat_params, jax_float64
from torch_instance_parity import one_torch_thread  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

LAYERS = [("sine", {}), ("sine", {"is_first": True}), ("finer", {}),
          ("finer", {"is_first": True}), ("gauss", {}), ("gabor", {}), ("relu", {}),
          ("sigmoid", {}), ("tanh", {})]


def _load_linear(lin: torch.nn.Linear, params: dict) -> None:
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(params["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.array(params["bias"])))


def _layer_pair(kind: str, kw: dict, n_in: int = 6, n_out: int = 5, seed: int = 0):
    jl = jinr._LAYER_TYPES[kind](n_out, **kw)
    x = np.random.default_rng(seed).uniform(-1, 1, (3, 4, n_in)).astype(np.float32)
    v = jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tl = inr.LAYER_TYPES[kind](n_in, n_out, **kw)
    _load_linear(tl.linear, v["params"]["Dense_0"])
    return jl, v, tl, x


@pytest.mark.parametrize("kind, kw", LAYERS)
def test_layer_and_its_gradients_match_jax(kind, kw):
    jl, v, tl, x = _layer_pair(kind, kw)
    w = np.random.default_rng(1).uniform(-1, 1, (3, 4, 5)).astype(np.float32)
    ref = jl.apply(v, jnp.asarray(x))
    (gv, gx) = jax.grad(lambda p, a: jnp.sum(jl.apply(p, a) * w), argnums=(0, 1))(
        v, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tl(xt)
    (out * torch.from_numpy(w)).sum().backward()
    assert_close(out, ref)
    assert_close(xt.grad, gx)
    assert_close(tl.linear.weight.grad.T, gv["params"]["Dense_0"]["kernel"])
    assert_close(tl.linear.bias.grad, gv["params"]["Dense_0"]["bias"])


def test_finer_first_bias_against_jax_in_float64():
    """FINER's first layer with a bias drawn in +-20: the sine's argument
    reaches thousands. The port and JAX's float32 layer are held to JAX's
    layer in float64; the bias is drawn from the caller's generator."""
    g = torch.Generator().manual_seed(3)
    tl = inr.FINERLayer(6, 5, is_first=True, first_bias_scale=20.0, generator=g)
    b = tl.linear.bias.detach()
    assert b.abs().max() <= 20.0 and b.abs().max() > 2.0
    jl = jinr.FINERLayer(5, is_first=True, first_bias_scale=20.0)
    x = np.random.default_rng(4).uniform(-1, 1, (3, 4, 6)).astype(np.float32)
    v = {"params": {"Dense_0": {"kernel": tl.linear.weight.detach().numpy().T.copy(),
                                "bias": b.numpy().copy()}}}
    ref32 = jl.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x))
    ref64 = jax_float64(lambda p, a: jl.apply(p, a), v, x)
    assert_witnessed(tl(torch.from_numpy(x)), ref32, ref64)


def test_siren_init_bounds_from_the_generator():
    g = torch.Generator().manual_seed(0)
    first = inr.SineLayer(4, 64, is_first=True, generator=g).linear.weight
    hidden = inr.SineLayer(64, 64, omega_0=30.0, generator=g).linear.weight
    assert first.abs().max() <= 1 / 4 and first.abs().max() > 0.2
    bound = math.sqrt(6 / 64) / 30
    assert hidden.abs().max() <= bound and hidden.abs().max() > 0.9 * bound
    again = inr.SineLayer(4, 64, is_first=True,
                          generator=torch.Generator().manual_seed(0)).linear.weight
    assert torch.equal(first, again)


@pytest.mark.parametrize("logscale", [True, False])
def test_positional_encoding_matches_jax(logscale):
    x = np.random.default_rng(5).uniform(-1, 1, (7, 2)).astype(np.float32)
    out = inr.positional_encoding(torch.from_numpy(x), 6, logscale)
    assert_close(out, jinr.positional_encoding(jnp.asarray(x), 6, logscale))


@pytest.mark.parametrize("kw", [
    {"layer_type": "sine"}, {"layer_type": "relu", "use_pe": True, "n_freqs": 4},
    {"layer_type": "gauss", "final_activation": "sigmoid"},
    {"layer_type": "finer", "final_activation": "tanh"}, {"layer_type": "gabor"}])
def test_inrnet_matches_jax(kw):
    """Weights through the bridge's Dense -> Linear rule (``layer{i}``'s
    ``Dense_0`` -> ``layers.layer{i}.linear``, ``out`` -> ``out``)."""
    from enhax_torch.convert.from_jax import _convert
    jn = jinr.INRNet(hidden_features=8, hidden_layers=2, out_features=3, **kw)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 9, 2)).astype(np.float32)
    v = jn.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tn = inr.INRNet(2, hidden_features=8, hidden_layers=2, out_features=3, **kw)
    sd = {}
    for key, a in flat_params(v).items():
        k = key.replace("params/", "").replace("/Dense_0/", "/linear/").replace("/", ".")
        k = k.replace("kernel", "weight")
        k = "layers." + k if k.startswith("layer") else k
        sd[k] = torch.from_numpy(np.ascontiguousarray(_convert(k, a, linear=True)))
    tn.load_state_dict(sd, strict=True)
    assert_close(tn(torch.from_numpy(x)), jn.apply(v, jnp.asarray(x)))


def test_coordinate_grid_and_context_windows_match_jax():
    for flatten in (True, False):
        assert_close(inr.coordinate_grid(5, 7, flatten), jinr.coordinate_grid(5, 7, flatten))
    x = np.random.default_rng(7).uniform(0, 1, (2, 6, 5, 1)).astype(np.float32)
    for window in (1, 2):
        assert_close(inr.context_window_features(torch.from_numpy(x), window),
                     jinr.context_window_features(jnp.asarray(x), window), 0.0)
    assert_close(inr.context_window_features(torch.from_numpy(x[0]), 1),
                 jinr.context_window_features(jnp.asarray(x[0]), 1), 0.0)
