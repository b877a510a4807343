"""Port parity on the CPU: PSENet against the JAX package at a narrow width
(``base_channels`` 4) on 32x32.

``good_looking_score`` against the JAX function in float64 (4x the JAX
function's own float32 gap: its local contrast cancels) and ``pseudo_gt``
(through the JAX function's ``rand01`` path on both sides) against the JAX
package's; the training
forward and the forward loss (the pseudo ground truth from the current
batch's detached output, the log-TV term) within 1e-5 x max(1, max|ref|)
of the JAX package in float64, every gradient within 1e-4 x max|ref|, both
packages' ``pseudo_gt`` taking ``rand01`` 0.5; the port's draws come from
the model's generator (the same each build, another each step); the
reference names through the JAX package's own loader;
``configs/psenet_sice_mix.py`` through both train CLIs for 2 steps (both
``pseudo_gt`` on ``rand01``); the registry entry."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import psenet as jpse
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import psenet as pse
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import (assert_close, assert_witnessed, jax_float64,  # noqa: F401
                                   pairs, shared_pair)
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"base_channels": 4}


def _dp(n=1, hw=32, seed=7):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.02, 0.7, (n, hw, hw, 3)).astype(np.float32)}


@pytest.fixture
def rand01(monkeypatch):
    """Both packages' ``pseudo_gt`` on ``rand01`` 0.5."""
    monkeypatch.setattr(jpse, "pseudo_gt", functools.partial(jpse.pseudo_gt, rand01=0.5))
    monkeypatch.setattr(pse, "pseudo_gt", functools.partial(pse.pseudo_gt, rand01=0.5))


@pytest.mark.parametrize("shape", [(2, 30, 34, 3), (1, 2, 26, 26, 3)])
def test_good_looking_score_matches_jax(shape):
    """The local contrast is E[x^2] - E[x]^2 over 25x25 windows, which
    float32 cancels: held to the JAX function in float64, within 4x the
    JAX function's own float32 gap from it."""
    x = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
    assert_witnessed(pse.good_looking_score(torch.from_numpy(x)),
                     jpse.good_looking_score(jnp.asarray(x)),
                     jax_float64(jpse.good_looking_score, x))


@pytest.mark.parametrize("number_refs, prev", [(1, True), (2, False), (3, True)])
def test_pseudo_gt_matches_jax_on_rand01(number_refs, prev):
    rng = np.random.default_rng(9)
    x = rng.uniform(0.02, 0.8, (2, 28, 28, 3)).astype(np.float32)
    p = rng.uniform(0.1, 0.9, x.shape).astype(np.float32) if prev else None
    ref = jpse.pseudo_gt(jnp.asarray(x), jax.random.PRNGKey(0),
                         None if p is None else jnp.asarray(p), number_refs=number_refs,
                         rand01=0.3)
    out = pse.pseudo_gt(torch.from_numpy(x), None,
                        None if p is None else torch.from_numpy(p), number_refs=number_refs,
                        rand01=0.3)
    assert_close(out, ref)


def test_forward_loss_and_gradients_match_jax(pairs, rand01):
    dp = _dp()
    jm, v, tm = shared_pair(pairs, "psenet", dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


def test_draws_come_from_the_models_generator():
    a, b = (build_model("psenet", device="cpu", seed=3, **SMALL) for _ in range(2))
    x = torch.from_numpy(_dp()["image"])
    la, lb = (m.forward_loss({"image": x})[0] for m in (a, b))
    assert float(la) == float(lb)
    assert float(a.forward_loss({"image": x})[0]) != float(la)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = shared_pair(pairs, "psenet", _dp(), **SMALL)
    check_round_trip(tm, v, mappings.psenet_name_map())
    keys = set(tm.module.state_dict())
    for k in ("model.first_conv.conv.0.weight", "model.first_conv.conv.2.weight",
              "model.first_conv.conv.3.fc.0.weight", "model.first_conv.conv.3.fc.2.bias",
              "model.conv1.conv.5.weight", "model.last_conv.conv.3.fc.0.weight"):
        assert k in keys, k


def test_config_trains_through_both_clis(tmp_path, monkeypatch, rand01):
    root = tmp_path / "data"
    fabricate(root, {f"sice_mix/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.4)), ("ref", (0.2, 1.0)))})
    tiny_config("configs/psenet_sice_mix.py", tmp_path / "tiny.py", SMALL,
                data_cfg={"batch_size": 2})
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     {**_dp(2), "ref_image": _dp(2)["image"]})
    assert name == "psenet"
    assert_clis_agree(jrun, prun, name)


def test_registry_entry_as_jax():
    jm, tm = jax_build_model("psenet"), build_model("psenet", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.forward_loss_fn is not None and tm.loss_fn is None
    assert build_model("psenet", device="cpu", base_number=4).param_count() == \
        build_model("psenet", device="cpu", **SMALL).param_count()
