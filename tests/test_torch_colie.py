"""Port parity on the CPU: CoLIE (``colie_re``, ``colie_hvi``,
``colie_hvid``) and the HVI colour space against the JAX package.

``rgb_to_hvi`` / ``hvi_to_rgb`` (values, the round trip, the gradient
through both and through the learned ``density_k``); every name's training
forward and loss, ``colie_hvid`` with and without a depth map, a batch of
two (the output's maximum over the whole batch), and a 3-step fit against
the JAX package's, with the JAX package's weights through the bridge
(``density_k``, and every Dense kernel as an ``nn.Linear`` weight).

Tolerances: ops, forward and loss 1e-5 x max(1, max|ref|); the fit 1e-4 x
max(1, max|ref|). The enhanced image comes through the bicubic fast guided
filter, whose window moments cancel in float32 (eps 1e-8): the JAX
package's own float32 output is up to ~2e-4 from its float64 evaluation.
The port takes those moments in float64, so ``enhanced`` (and the loss,
where it enters) is held to the JAX package's forward and fit in float64
(``jax.enable_x64``): within max(tol, 4 x the JAX package's own gap), the
gap asserted; the fit against the JAX package's fit in float64 within 1e-4
x max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.ops import color as jcolor
from enhax_torch.models.base import build_model
from enhax_torch.ops import color
from torch_instance_parity import (assert_close, check_fit, check_forward_loss, datapoint,
                                   pair)
from torch_instance_parity import one_torch_thread, pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"down_size": 32, "hidden_dim": 16}
NAMES = ["colie_re", "colie_hvi", "colie_hvid"]


def test_hvi_matches_jax_and_round_trips():
    x = np.random.default_rng(0).uniform(0.02, 1, (2, 12, 10, 3)).astype(np.float32)
    x[:, 0, :3, 1] = x[:, 0, :3, 0]                       # r == g
    for k in (0.2, 0.7):
        hvi = color.rgb_to_hvi(torch.from_numpy(x), k)
        assert_close(hvi, jcolor.rgb_to_hvi(jnp.asarray(x), k))
        back = color.hvi_to_rgb(hvi, k)
        assert_close(back, jcolor.hvi_to_rgb(jnp.asarray(hvi.numpy()), k))
        assert_close(back, x, 1e-5)


def test_hvi_gradients_match_jax():
    """d/dx and d/dk of a weighted sum of hvi_to_rgb(rgb_to_hvi(x, k), k)."""
    x = np.random.default_rng(1).uniform(0.05, 0.95, (1, 8, 8, 3)).astype(np.float32)
    w = np.random.default_rng(2).uniform(-1, 1, x.shape).astype(np.float32)

    def jloss(a, k):
        h = jcolor.rgb_to_hvi(a, k)
        return jnp.sum(jcolor.hvi_to_rgb(h, k) * w) + jnp.sum(h * w[..., ::-1])

    gx, gk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.float32(0.3))
    t = torch.tensor(x, requires_grad=True)
    k = torch.tensor(0.3, requires_grad=True)
    h = color.rgb_to_hvi(t, k)
    loss = ((color.hvi_to_rgb(h, k) * torch.from_numpy(w)).sum()
            + (h * torch.from_numpy(w[..., ::-1].copy())).sum())
    loss.backward()
    assert_close(t.grad, gx)
    assert_close(k.grad, gk)


@pytest.mark.parametrize("name, depth", [("colie_re", False), ("colie_hvi", False),
                                         ("colie_hvid", True), ("colie_hvid", False)])
def test_forward_and_loss_match_jax(name, depth, pairs):
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=3)
    if not depth:
        dp.pop("depth", None)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_forward_loss(jm, v, tm, dp, witness=("enhanced",))


def test_batch_max_over_the_whole_batch():
    """Two images, a dark and a bright one: the output is divided by the
    maximum over both, as the JAX package's."""
    jm0 = jax_build_model("colie_re", **SMALL)
    dp = {"image": np.concatenate([datapoint(jm0, 40, seed=4, hi=0.3)["image"],
                                   datapoint(jm0, 40, seed=5, lo=0.3, hi=0.9)["image"]])}
    jm, v, tm = pair("colie_re", dp, **SMALL)
    check_forward_loss(jm, v, tm, dp, witness=("enhanced",))
    with torch.no_grad():
        out = tm.apply({"image": torch.from_numpy(dp["image"])})["enhanced"]
    assert float(out.max()) == 1.0


@pytest.mark.parametrize("name", NAMES)
def test_three_step_fit_matches_jax(name, pairs):
    """3 AdamW steps (lr 1e-5, decay 3e-4) over every parameter
    (``density_k`` too), against the JAX fit in float64."""
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=6)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_fit(jm, v, tm, dp, witness="f64")


@pytest.mark.parametrize("name", NAMES + ["colie"])
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "optional_inputs",
                 "instance_steps", "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert hasattr(tm.module, "density_k") == ("hvi" in tm.name)
