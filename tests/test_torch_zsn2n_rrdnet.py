"""Port parity on the CPU: ZSN2N and RRDNet against the JAX package.

``pair_downsample``; RRDNet's gradient and zero-padded Gaussian and its
loss; each model's forward and loss (ZSN2N's three forwards a step through
``forward_loss_fn``), and a 3-step instance fit (``make_instance_infer``,
and ``Predictor`` for ZSN2N) against the JAX package's of the same steps,
with the JAX package's weights through the bridge. Tolerances: ops,
forward and loss 1e-5 x max(1, max|ref|); the fit 1e-4 x max(1, max|ref|)
(``tests/torch_instance_parity.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.llie import rrdnet as jrrd
from enhax.ops.geometry import pair_downsample as jax_pair_downsample
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import rrdnet
from enhax_torch.ops.geometry import pair_downsample
from enhax.models.base import build_model as jax_build_model
from torch_instance_parity import assert_close, check_fit, check_forward_loss, datapoint, pair
from torch_instance_parity import one_torch_thread  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


@pytest.mark.parametrize("shape", [(2, 16, 12, 3), (1, 15, 21, 1), (17, 9, 2)])
def test_pair_downsample_matches_jax(shape):
    """Even and odd sizes (an odd last row or column dropped), with and
    without a batch axis."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    for out, ref in zip(pair_downsample(torch.from_numpy(x)), jax_pair_downsample(jnp.asarray(x))):
        assert_close(out, ref, 0.0)


def test_rrdnet_gradient_and_gauss_match_jax():
    x = np.random.default_rng(1).uniform(0, 1, (2, 20, 17, 3)).astype(np.float32)
    refs = jrrd._ref_gradient(jnp.asarray(x))
    for out, ref in zip(rrdnet.ref_gradient(torch.from_numpy(x)), refs):
        assert_close(out, ref)
    assert_close(rrdnet.gauss5_zero(torch.from_numpy(x)), jrrd._gauss5_zero(jnp.asarray(x)))


@pytest.mark.parametrize("name, kw", [("zsn2n", {}), ("zsn2n", {"num_channels": 16}),
                                      ("rrdnet_re", {})])
def test_forward_and_loss_match_jax(name, kw):
    dp = datapoint(jax_build_model(name, **kw), hw=48, seed=2)
    jm, v, tm = pair(name, dp, **kw)
    check_forward_loss(jm, v, tm, dp)


@pytest.mark.parametrize("name, predictor", [("zsn2n", True), ("rrdnet_re", False)])
def test_three_step_fit_matches_jax(name, predictor):
    """The fit steps every weight from the Predictor's (Adam at the models'
    lr 1e-3); ZSN2N's through both packages' ``Predictor``."""
    dp = datapoint(jax_build_model(name), hw=48, seed=3, lo=0.1, hi=0.9)
    jm, v, tm = pair(name, dp)
    check_fit(jm, v, tm, dp, predictor=predictor)


@pytest.mark.parametrize("name", ["zsn2n", "rrdnet_re", "rrdnet"])
def test_registry_entries_as_jax(name):
    jm = jax_build_model(name)
    tm = build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "instance_steps",
                 "instance_lr", "instance_weight_decay", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert (tm.forward_loss_fn is None) == (jm.forward_loss_fn is None)


def test_weights_come_from_the_generator():
    """Two builds with one seed are equal, another seed differs, and
    building draws nothing from torch's global generator."""
    state = torch.random.get_rng_state()
    a = build_model("rrdnet_re", device="cpu", seed=5).module.state_dict()
    b = build_model("rrdnet_re", device="cpu", seed=5).module.state_dict()
    c = build_model("rrdnet_re", device="cpu", seed=6).module.state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["noise_net.conv1.weight"], c["noise_net.conv1.weight"])
