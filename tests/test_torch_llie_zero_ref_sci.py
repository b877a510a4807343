"""Port parity on the CPU: SCI and RUAS against the JAX package at their
published widths on 40x40 (the CLI at 32x32).

``sci_smooth_loss`` (24 offsets, YCbCr weights) at SCI's and RUAS's sigma;
the training forward, the loss and every gradient (``check_forward_loss_grads``:
forward and loss within 1e-5 x max(1, max|ref|) in float32, gradients
within 1e-4 x max|ref| in float64), SCI on numpy draws of its weights and
BatchNorm statistics; SCI's
forward in train mode equal to its eval forward, its statistics untouched
by a Trainer step; the bridge round trips through the JAX package's own
loader (SCI's statistics into the running buffers, its shared blocks under
``blocks.i``); the registry entries. SCI's train CLI:
``tests/test_torch_llie_zero_ref_sci_cli.py``."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import sci as jsci
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import sci as tsci
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train.trainer import Trainer
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import (assert_close, drawn_variables, flat_params, pairs,  # noqa: F401
                                   shared_pair)
from torch_threads import capped_torch_threads  # noqa: F401

def _dp(n=1, hw=40, seed=11, lo=0.02, hi=0.5):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(lo, hi, (n, hw, hw, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def sci_pair():
    """SCI in both packages on numpy draws of its weights and BatchNorm
    statistics (at flax's init the statistics are 0 and 1)."""
    jm = jax_build_model("sci")
    dp = _dp()
    v = drawn_variables(jm, {k: jnp.asarray(a) for k, a in dp.items()}, 12)
    tm = build_model("sci", device="cpu")
    tm.module.load_state_dict(jax_to_torch_state_dict("sci", flat_params(v)), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("sigma", [10.0, 0.1])
def test_sci_smooth_loss_matches_jax(sigma):
    rng = np.random.default_rng(13)
    image = rng.uniform(0, 1, (2, 21, 27, 3)).astype(np.float32)
    illu = rng.uniform(0, 1, image.shape).astype(np.float32)
    ref = jsci.sci_smooth_loss(jnp.asarray(image), jnp.asarray(illu), sigma=sigma)
    out = tsci.sci_smooth_loss(torch.from_numpy(image), torch.from_numpy(illu), sigma=sigma)
    assert_close(out, ref)


def test_sci_forward_loss_and_gradients_match_jax(sci_pair):
    jm, v, tm = sci_pair
    check_forward_loss_grads(jm, v, tm, _dp())


def test_ruas_forward_loss_and_gradients_match_jax(pairs):
    dp = _dp()
    jm, v, tm = shared_pair(pairs, "ruas", dp)
    check_forward_loss_grads(jm, v, tm, dp)


def test_sci_train_mode_forward_is_its_eval_forward(sci_pair):
    """The BatchNorms normalise with the running statistics in train mode
    too, and a Trainer step leaves the statistics as they were."""
    tm = dataclasses.replace(sci_pair[2], module=copy.deepcopy(sci_pair[2].module))
    x = torch.from_numpy(_dp(n=2, seed=15)["image"])
    module = tm.module
    with torch.no_grad():
        module.eval()
        ref = module(x)
        module.train()
        out = module(x)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    stats = {k: b.clone() for k, b in module.named_buffers()}
    weights = {k: p.detach().clone() for k, p in module.named_parameters()}
    tr = Trainer(tm, build_optimizer({"optimizer": {"name": "adam", "lr": 1e-2}}))
    state = tr.init_state()
    tr._train_step(state, {"image": x})
    assert all(torch.equal(b, stats[k]) for k, b in state.module.named_buffers())
    assert any(not torch.equal(p, weights[k]) for k, p in state.module.named_parameters())


def test_sci_bridge_round_trip(sci_pair):
    jm, v, tm = sci_pair
    keys = set(tm.module.state_dict())
    for k in ("enhance.in_conv.0.weight", "enhance.conv.1.running_mean",
              "enhance.blocks.0.1.running_var", "calibrate.in_conv.1.weight",
              "calibrate.convs.4.running_var", "calibrate.blocks.2.3.weight",
              "calibrate.out_conv.0.bias", "calibrate.convs.1.num_batches_tracked"):
        assert k in keys, k
    sd = tm.module.state_dict()
    assert torch.equal(sd["calibrate.blocks.2.4.running_mean"], sd["calibrate.convs.4.running_mean"])
    check_round_trip(tm, v, mappings.sci_name_map(),
                     drop=lambda k: ".blocks." in k or k.endswith("num_batches_tracked"))


def test_ruas_bridge_round_trip(pairs):
    jm, v, tm = shared_pair(pairs, "ruas", _dp())
    keys = set(tm.module.state_dict())
    for k in ("enhance_net.iems.0.cell.c1_r.op.weight", "enhance_net.iems.2.cell.c2_d.op.bias",
              "enhance_net.iems.1.cell.c5.weight", "denoise_net.stem.weight",
              "denoise_net.nrms.2.c1_d.op.weight", "denoise_net.activate.0.bias"):
        assert k in keys, k
    check_round_trip(tm, v, mappings.ruas_name_map())


@pytest.mark.parametrize("name", ["sci", "ruas"])
def test_registry_entry_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.loss_fn is not None and tm.forward_loss_fn is None
