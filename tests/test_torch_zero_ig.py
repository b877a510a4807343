"""Port parity on the CPU: ZERO-IG (``zero_ig_re``, ``zero_ig``) against the
JAX package at a narrow width (``num_channels`` 8, ``embed_channels`` 6) on
32x32.

The blur, the local means, deviations and variances (reflect against zero
padding), the texture gate and the flat-view smoothness loss against the
JAX package's; the training forward (every map) and the reference's loss
within 1e-5 x max(1, max|ref|) of the JAX package, every gradient
within 1e-4 x max|ref| (the BatchNorm's statistics included); a
3-step fit through both ``Predictor``s' instance route (1e-4 x max(1,
max|ref|)); the Trainer leaves the statistics alone, as the JAX package's
trainer leaves ``batch_stats``; the reference names (the shared block under
``blocks.{i}`` too) loaded by the port and read back by the JAX package's
own loader; ``configs/zero_ig_re_lol_v1.py`` through both train CLIs for 2
steps; the registry entries. The loss and its gradients in float32 (the
JAX package's blur kernel is float32, so its loss does not run in
float64)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import zero_ig as jzig
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import zero_ig as zig
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train.trainer import Trainer, make_train_step
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import (assert_close, check_fit, drawn_variables,  # noqa: F401
                                   pair, pairs)
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"num_channels": 8, "embed_channels": 6}


def _dp(n=1, hw=32, seed=10):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.02, 0.5, (n, hw, hw, 3)).astype(np.float32)}


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("fn", ["_blur21", "_local_var5", "_local_mean5_reflect",
                                "_local_stddev5_reflect"])
def test_filters_match_jax(fn):
    x = np.random.default_rng(11).uniform(0, 1, (2, 24, 28, 3)).astype(np.float32)
    assert_close(_nhwc(getattr(zig, fn)(_nchw(x))), getattr(jzig, fn)(jnp.asarray(x)))


def test_texture_gate_and_smoothness_match_jax():
    rng = np.random.default_rng(12)
    a = rng.uniform(0, 1, (2, 16, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.02, a.shape), 0, 1).astype(np.float32)
    b[:, :, 10:] = rng.uniform(0.4, 0.6, b[:, :, 10:].shape)   # half the texture gone
    gate = _nhwc(zig.texture_difference(_nchw(a), _nchw(b)))
    ref = np.asarray(jzig.texture_difference(jnp.asarray(a), jnp.asarray(b)))
    assert 0.0 < float(gate.mean()) < 1.0
    assert_close(gate, ref, 0.0)
    assert_close(zig._smooth_loss(_nchw(a), _nchw(b)),
                 jzig._smooth_loss(jnp.asarray(a), jnp.asarray(b)))


@pytest.fixture(scope="module")
def zero_ig_pair():
    """The JAX init's weights with the BatchNorm statistics drawn away from
    (0, 1), so that the statistics' gradients and the bridge's names are
    held."""
    dp = _dp()
    jm = jax_build_model("zero_ig_re", **SMALL)
    v = jax.jit(jm.init)(jax.random.PRNGKey(1), {k: jnp.asarray(a) for k, a in dp.items()})
    stats = drawn_variables(jm, {k: jnp.asarray(a) for k, a in dp.items()}, 2)["batch_stats"]
    v = {**v, "batch_stats": stats}
    return pair("zero_ig_re", dp, init="given", variables=v, **SMALL)


def test_forward_loss_and_gradients_match_jax(zero_ig_pair):
    """In float32 in both packages (the JAX package's blur kernel is
    float32, so its loss does not run in float64)."""
    jm, v, tm = zero_ig_pair
    check_forward_loss_grads(jm, v, tm, _dp(), x64=False)


def test_three_step_fit_through_both_predictors(zero_ig_pair):
    """``Predictor``'s instance route, 3 Adam steps at 1e-4 on 30x26 (padded
    to the divisor 2: no pad), every parameter and statistic stepped."""
    jm, v, tm = zero_ig_pair
    dp = {"image": _dp(hw=32, seed=13)["image"][:, :30, :26]}
    check_fit(jm, v, tm, dp, predictor=True, keys=("enhanced",))


def test_trainer_leaves_the_statistics(zero_ig_pair):
    tm = zero_ig_pair[2]
    tm = dataclasses.replace(tm, module=copy.deepcopy(tm.module))
    tr = Trainer(tm, build_optimizer({"optimizer": {"name": "adam", "lr": 1e-3}}))
    state = tr.init_state()
    stats = {n: p.detach().clone() for n, p in tm.module.named_parameters() if "running" in n}
    assert len(stats) == 2
    step = make_train_step(tm, tr.tx)
    before = {n: p.detach().clone() for n, p in tm.module.named_parameters()}
    step(state, {"image": torch.from_numpy(_dp()["image"])})
    for n, p in tm.module.named_parameters():
        if n in stats:
            assert torch.equal(p, stats[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in tm.module.named_parameters())


def test_bridge_round_trip_under_the_reference_names(zero_ig_pair):
    jm, v, tm = zero_ig_pair
    keys = set(tm.module.state_dict())
    for k in ("enhance.in_conv.0.weight", "enhance.conv.0.weight", "enhance.conv.1.running_var",
              "enhance.conv.1.num_batches_tracked", "enhance.blocks.2.1.running_mean",
              "enhance.out_conv.0.bias", "denoise2.conv3.weight"):
        assert k in keys, k
    check_round_trip(tm, v, mappings.zero_ig_name_map(),
                     drop=lambda k: ".blocks." in k or k.endswith("num_batches_tracked"))


def test_config_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"lol_v1/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.3)), ("ref", (0.2, 1.0)))})
    tiny_config("configs/zero_ig_re_lol_v1.py", tmp_path / "tiny.py", SMALL)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     {**_dp(), "ref_image": _dp()["image"]})
    assert name == "zero_ig_re"
    assert_clis_agree(jrun, prun, name)


@pytest.mark.parametrize("name", ["zero_ig_re", "zero_ig"])
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    assert tm.name == jm.name == "zero_ig_re"
    for attr in ("arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps", "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
