"""Port parity on the CPU: PairLIE against the JAX package at 8 features on
40x40.

The training forward, the loss (``pairlie_forward_loss``, the detached
illumination in the reflectance term) and every gradient
(``check_forward_loss_grads``: forward and loss within 1e-5 x max(1,
max|ref|) in float32, gradients within 1e-4 x max|ref| in float64); the
cross-view term of a second view (``image2``); the bridge under the
reference's names through the JAX package's own loader; the registry
entry."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax_torch.models.base import build_model
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import assert_close, pairs, shared_pair, to_torch  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"pairlie": {"num": 8}}


def _dp(n=1, hw=40, seed=11, lo=0.02, hi=0.5):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(lo, hi, (n, hw, hw, 3)).astype(np.float32)}


def test_forward_loss_and_gradients_match_jax(pairs):
    dp = _dp()
    jm, v, tm = shared_pair(pairs, "pairlie", dp, **SMALL["pairlie"])
    check_forward_loss_grads(jm, v, tm, dp)


def test_pairlie_second_view_matches_jax(pairs):
    """The cross-view term, MSE of the two views' reflectances: the loss
    with ``image2`` against the JAX package's in float32, and the term (the
    loss with the second view less the loss without) against the JAX
    package's in float64 in both, where the term (about 1e-7 of a loss of
    about 40 on these weights) is not lost to the loss's rounding."""
    one = _dp()
    two = {**one, "image2": _dp(seed=14, lo=0.3, hi=1.0)["image"]}
    jm, v, tm = shared_pair(pairs, "pairlie", one, **SMALL["pairlie"])
    ref_loss, _ = jax.jit(lambda w, d: jm.forward_loss(w, d))(v, two)
    with torch.no_grad():
        assert_close(tm.forward_loss(to_torch(two))[0], ref_loss)
    terms = []
    with jax.enable_x64(True):
        fl = jax.jit(lambda w, d: jm.forward_loss(w, d)[0])
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        terms.append(float(fl(v64, {k: jnp.asarray(a, jnp.float64) for k, a in two.items()})
                           - fl(v64, {k: jnp.asarray(a, jnp.float64) for k, a in one.items()})))
    t64 = dataclasses.replace(tm, module=copy.deepcopy(tm.module).double())
    with torch.no_grad():
        terms.append(float(t64.forward_loss({k: torch.from_numpy(a).double()
                                             for k, a in two.items()})[0]
                           - t64.forward_loss({"image": torch.from_numpy(one["image"]).double()})[0]))
    assert terms[0] > 0
    assert abs(terms[1] - terms[0]) <= 1e-5 * terms[0], terms


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = shared_pair(pairs, "pairlie", _dp(), **SMALL["pairlie"])
    keys = set(tm.module.state_dict())
    for k in ("N_net.N_net.1.weight", "L_net.L_net.13.bias", "R_net.R_net.7.weight"):
        assert k in keys, k
    check_round_trip(tm, v, mappings.pairlie_name_map())


def test_registry_entry_as_jax():
    jm, tm = jax_build_model("pairlie"), build_model("pairlie", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.forward_loss_fn is not None and tm.loss_fn is None
    assert build_model("pairlie", device="cpu", **SMALL["pairlie"]).param_count() == sum(
        a.size for a in jax.tree_util.tree_leaves(jax.eval_shape(
            jax_build_model("pairlie", **SMALL["pairlie"]).init, jax.random.PRNGKey(0),
            {"image": jnp.zeros((1, 16, 16, 3))})))
