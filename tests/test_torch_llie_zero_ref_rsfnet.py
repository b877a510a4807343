"""Port parity on the CPU: RSFNet (an instance model) against the JAX
package at its published width on 32x32.

The training forward, the loss and every gradient (``check_forward_loss_grads``:
1e-5 x max(1, max|ref|) in float32, gradients 1e-4 x max|ref| in float64)
at thresholds and steps drawn away from their init (where no channel
vector is zero: ``tests/test_torch_llie_zero_ref_rsfnet_fit.py`` holds the
init and the fit), at a batch of two (the dual variable's norm runs over
the whole batch, so two images together are not each alone); the bridge
under the reference's names through the JAX package's own loader; the
registry entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax_torch.models.base import build_model
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import one_torch_thread, pair, to_torch  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


def _dp(n=1, hw=32, seed=21):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.02, 0.5, (n, hw, hw, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def rsf_pair():
    """RSFNet in both packages at the JAX package's init."""
    return pair("rsfnet", _dp())


def _drawn_thresholds(v, seed: int = 22):
    """``v`` with lambda_a, lambda_e in [0.005, 0.05] and steps 1 +- 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf.startswith("lambda_"):
            return jnp.asarray(rng.uniform(0.005, 0.05), a.dtype)
        if leaf.startswith("step_"):
            return jnp.asarray(1.0 + rng.uniform(-0.1, 0.1), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, v)


def test_forward_loss_and_gradients_match_jax():
    """Thresholds away from 0: no channel vector is zero, the JAX
    package's gradients are finite and the port's agree with them."""
    dp = _dp(2)
    jm, v, tm = pair("rsfnet", dp, init="given", variables=_drawn_thresholds(
        jax.jit(jax_build_model("rsfnet").init)(jax.random.PRNGKey(3), dp)))
    check_forward_loss_grads(jm, v, tm, dp)


def test_dual_variable_norm_spans_the_batch(rsf_pair):
    """Two images through one forward are not each image alone: the dual
    variable divides by the norm of the whole batch."""
    two = _dp(2)
    jm, v, tm = pair("rsfnet", two, init="given", variables=_drawn_thresholds(rsf_pair[1]))
    ref = jm.apply(v, two)["enhanced"]
    with torch.no_grad():
        out = tm.apply(to_torch(two))["enhanced"]
        alone = torch.cat([tm.apply({"image": torch.from_numpy(two["image"][i:i + 1])})[
            "enhanced"] for i in range(2)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert float((out - alone).abs().max()) > 1e-4


def test_bridge_round_trip_under_the_reference_names(rsf_pair):
    jm, v, tm = rsf_pair
    keys = set(tm.module.state_dict())
    for k in ("lambda_a.0.0", "lambda_e.4.2", "step.2.1", "e_conv1.weight", "e_conv3.bias",
              "d_conv7.weight"):
        assert k in keys, k
    assert not any(k.startswith("e_conv4") for k in keys)
    check_round_trip(tm, v, mappings.rsfnet_name_map())


def test_registry_entry_as_jax():
    jm, tm = jax_build_model("rsfnet"), build_model("rsfnet", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps", "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    params = dict(tm.module.named_parameters())
    assert params["lambda_a.3.1"].item() == 0.0 and params["step.3.1"].item() == 1.0
