"""Port parity on the CPU: the losses of the low-light families
(``edge_loss`` with its Laplacian residual, ``color_loss``,
``histogram_loss``, ``perceptual_loss`` with its average-pool pyramid and
``preprocess``) and MPRNet's ``edge_charbonnier_loss`` (at MPRNet's edge
weight 0.05, and at other weights of all three terms) against the JAX package's, values and input gradients,
within 1e-5 relative (max|Δ| over max(1, max|ref|) for the value, over
max|ref| for the gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.constants import LOSSES as JAX_LOSSES
from enhax.nn import losses as jlosses
from enhax_torch.constants import LOSSES
from enhax_torch.nn import losses
from torch_instance_parity import assert_close
from torch_threads import capped_torch_threads  # noqa: F401

CASES = [("edge_loss", {}), ("edge_loss", {"loss_weight": 50.0}), ("color_loss", {}),
         ("histogram_loss", {}), ("histogram_loss", {"bins": 64, "sigma": 0.05}),
         ("perceptual_loss", {}), ("perceptual_loss", {"preprocess": True}),
         ("edge_charbonnier_loss", {"edge_loss_weight": 0.05}),
         ("edge_charbonnier_loss", {"edge_loss_weight": 2.0, "char_loss_weight": 0.5,
                                    "loss_weight": 3.0})]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name, kw", CASES)
@pytest.mark.parametrize("shape", [(2, 32, 28, 3), (1, 37, 41, 3)])
def test_loss_and_gradient_match_jax(name, kw, shape):
    x, y = _pair(shape, 0)
    jfn = JAX_LOSSES.build(name, **kw)
    ref, gref = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = LOSSES.build(name, **kw)(xt, torch.from_numpy(y))
    out.backward()
    assert_close(out.detach(), ref, 1e-5)
    g, gr = xt.grad.double().numpy(), np.asarray(gref, np.float64)
    assert np.abs(g - gr).max() <= 1e-5 * np.abs(gr).max()


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (2, 13, 18, 1)])
def test_laplacian_residual_matches_jax(shape):
    """The border mode (replicate) and the zero grid of the upsample."""
    x, _ = _pair(shape, 1)
    assert_close(losses._laplacian_pyramid_residual(torch.from_numpy(x)),
                 jlosses._laplacian_pyramid_residual(jnp.asarray(x)), 1e-6)


def test_losses_registered_under_the_jax_names():
    for name in ("edge_loss", "color_loss", "histogram_loss", "perceptual_loss",
                 "edge_charbonnier_loss"):
        assert name in LOSSES and name in JAX_LOSSES
