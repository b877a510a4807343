"""Port parity on the CPU: AirNet (``airnet``) against the JAX package at a
narrow width (8 features, one group of one block), on weights and
BatchNorm statistics drawn with numpy (the DCNs' offset convs nonzero, so
their samples land between and beyond pixels).

The training forward (``enhanced``, ``degradation``) and the L1 loss within
1e-5 x max(1, max|ref|) in float32, every gradient within 1e-4 x max|ref|
in float64; the forward on the batch's statistics and the running
statistics it leaves against the JAX package's ``apply_train`` (flax's
momentum 0.99, the biased variance); ``nn.layers.BatchNorm`` against
flax's ``nn.BatchNorm``; the Trainer's steps (the statistics updated in a
float32 step, once under remat, left alone in bf16-mixed); the reference
names read back by the JAX package's own loader, and a released state dict
with the contrastive encoder's other entries loaded as it is; a ragged
request through both packages' ``Predictor``s; the init (zero offset
convs, so that every DCN starts as half a 3x3 conv); the registry entry. Two
train steps through both train CLIs: ``tests/test_torch_airnet_cli.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from enhax.convert import mappings
from enhax.infer import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.nn.layers import BatchNorm
from enhax_torch.nn.optim import build_optimizer
from enhax_torch.train.trainer import Trainer
from test_torch_lllinet import supervised_dp
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import (TOL, assert_close, flat_params, pairs,  # noqa: F401
                                   shared_pair, to_torch)
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"n_feats": 8, "n_groups": 1, "n_blocks": 1}
STATS = ("running_mean", "running_var")


def _pair(pairs):
    return shared_pair(pairs, "airnet", supervised_dp(hw=20, seed=6), init="numpy", **SMALL)


def _stats(module) -> dict:
    return {k: t.clone() for k, t in module.state_dict().items() if k.endswith(STATS)}


def test_forward_loss_and_gradients_match_jax(pairs):
    jm, v, tm = _pair(pairs)
    check_forward_loss_grads(jm, v, tm, supervised_dp(hw=20, seed=6), grads32=False)


def test_batch_statistics_forward_matches_jax_apply_train(pairs):
    """``Model.apply(..., batch_stats=True)`` against ``apply_train``: the
    outputs normalised with the batch's statistics, and the running
    statistics it leaves."""
    jm, v, tm = _pair(pairs)
    dp = supervised_dp(hw=20, seed=7, n=2)
    ref, new_stats = jax.jit(lambda w, d: jm.apply_train(w, d))(v, dp)
    m = copy.deepcopy(tm)
    out = m.apply(to_torch(dp), training=True, batch_stats=True)
    for k in ("enhanced", "degradation"):
        assert_close(out[k].detach(), ref[k])
    # the batch's statistics moved the output away from the running ones'
    frozen = tm.apply(to_torch(dp))["degradation"].detach()
    assert (frozen - out["degradation"].detach()).abs().max() > 1e-2
    want = {k: t for k, t in jax_to_torch_state_dict(
        "airnet", flat_params({"batch_stats": new_stats})).items() if k.endswith(STATS)}
    got = _stats(m.module)
    assert set(got) == set(want) and len(got) == 6
    for k, t in want.items():
        assert_close(got[k], t.numpy(), TOL)
        assert (got[k] - tm.module.state_dict()[k]).abs().max() > 1e-4, k
    assert all(int(t) == 1 for k, t in m.module.state_dict().items()
               if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("shape", [(2, 5, 6, 4), (1, 3, 3, 7)])
def test_batchnorm_is_flax_batchnorm(shape):
    """flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-5): on the batch's
    statistics with the updated running ones, and on running ones."""
    rng = np.random.default_rng(8)
    x = (rng.normal(0.3, 2.0, shape)).astype(np.float32)
    c = shape[-1]
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.2, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.5, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.tensor(variables["params"]["scale"]),
                        "bias": torch.tensor(variables["params"]["bias"]),
                        "running_mean": torch.tensor(variables["batch_stats"]["mean"]),
                        "running_var": torch.tensor(variables["batch_stats"]["var"])},
                       strict=False)
    ref = fnn.BatchNorm(use_running_average=True).apply(variables, jnp.asarray(x))
    assert_close(bn(torch.from_numpy(x)).detach(), ref, 1e-6)
    ref, mut = fnn.BatchNorm(use_running_average=False).apply(variables, jnp.asarray(x),
                                                              mutable=["batch_stats"])
    assert_close(bn(torch.from_numpy(x), train=True).detach(), ref, 1e-6)
    assert_close(bn.running_mean, mut["batch_stats"]["mean"], 1e-7)
    assert_close(bn.running_var, mut["batch_stats"]["var"], 1e-7)
    var = x.reshape(-1, c).var(0)   # biased: torch's BatchNorm2d stores the unbiased one
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.99 * variables["batch_stats"]["var"] + 0.01 * var, rtol=1e-5)


def _trainer_step(tm, precision=None, remat=False):
    m = copy.deepcopy(tm)
    tr = Trainer(m, build_optimizer({"optimizer": {"name": "adam", "lr": 1e-3}}),
                 precision=precision, remat=remat)
    state = tr.init_state()
    batch = to_torch(supervised_dp(hw=20, seed=9, n=2))
    loss = tr._train_step(state, batch)["loss"].item()
    return loss, m


def test_train_step_takes_batch_statistics_in_float32_only(pairs):
    """A float32 step updates the statistics from the batch (remat: once,
    and the same gradients as without it), no optimizer steps them;
    bf16-mixed leaves them."""
    _, _, tm = _pair(pairs)
    before = _stats(tm.module)
    loss, m = _trainer_step(tm)
    loss_remat, m_remat = _trainer_step(tm, remat=True)
    _, m16 = _trainer_step(tm, precision="bf16-mixed")
    assert loss == pytest.approx(loss_remat, rel=1e-6)
    after, after_remat = _stats(m.module), _stats(m_remat.module)
    for k in before:
        assert (after[k] - before[k]).abs().max() > 1e-4, k
        assert torch.equal(after_remat[k], after[k]), k
        assert torch.equal(_stats(m16.module)[k], before[k]), k
    sd = m_remat.module.state_dict()
    assert all(int(sd[k]) == 1 for k in sd if k.endswith("num_batches_tracked"))
    # the step's gradients (Adam's first step is +-lr by their signs, which
    # rounding picks where one is near 0: the CPU's scatter-add of the DCN's
    # gather sums in no fixed order)
    for (k, p), (_, q) in zip(m.module.named_parameters(), m_remat.module.named_parameters()):
        assert_close(q.grad, p.grad.numpy(), 1e-5)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = _pair(pairs)
    check_round_trip(tm, v, mappings.airnet_name_map(n_groups=1, n_blocks=1),
                     drop=lambda k: k.endswith("num_batches_tracked"))
    keys = set(tm.module.state_dict())
    for k in ("E.E.encoder_q.E_pre.backbone.0.weight", "E.E.encoder_q.E_pre.backbone.4.running_var",
              "E.E.encoder_q.E_pre.shortcut.1.num_batches_tracked", "R.head.0.bias",
              "R.body.0.body.0.dgm2.dcn.weight", "R.body.0.body.0.dgm1.dcn.conv_offset_mask.bias",
              "R.body.0.body.0.dgm1.sft.conv_beta.2.weight", "R.body.0.body.1.weight",
              "R.body.1.weight", "R.tail.0.weight"):
        assert k in keys, k


def test_released_state_dict_loads_without_the_contrastive_encoder(pairs):
    """The rest of the MoCo query encoder, its key encoder and queue, and
    the projection head are entries the restorer never reads."""
    _, _, tm = _pair(pairs)
    sd = dict(tm.module.state_dict())
    sd.update({"E.E.encoder_q.E.0.backbone.0.weight": torch.zeros(16, 8, 3, 3),
               "E.E.encoder_q.mlp.0.weight": torch.zeros(256, 256),
               "E.E.encoder_k.E_pre.backbone.0.weight": torch.zeros(8, 3, 3, 3),
               "E.E.queue": torch.zeros(256, 12), "E.E.queue_ptr": torch.zeros(1)})
    m = build_model("airnet", device="cpu", **SMALL)
    m.module.load_state_dict(sd, strict=True)
    x = to_torch(supervised_dp(hw=12, seed=2))
    with torch.no_grad():
        assert torch.equal(m.apply(x)["enhanced"], tm.apply(x)["enhanced"])


def test_predictor_ragged_request_as_jax(pairs):
    jm, v, tm = _pair(pairs)
    x = np.random.default_rng(5).uniform(0.05, 0.9, (2, 19, 23, 3)).astype(np.float32)
    ref = JaxPredictor(jm, variables=v).infer({"image": x})
    out = Predictor(tm, device="cpu").infer({"image": x})
    assert tm.size_divisor == jm.size_divisor == 1
    for key in ("enhanced", "degradation"):
        assert out[key].shape[:3] == x.shape[:3], key
        assert_close(out[key], ref[key])


def test_init_as_jax():
    """Every offset conv zero (weight and bias: at init every offset is 0
    and every mask 0.5, so a DCN is half a 3x3 conv), the DCN weights
    U(+-1/sqrt(C k^2)), the other convs' biases zero."""
    tm = build_model("airnet", device="cpu", seed=3, n_feats=16, n_groups=2, n_blocks=2)
    dcns = [m for m in tm.module.modules() if type(m).__name__ == "DCN"]
    assert len(dcns) == 2 * 2 * 2
    for m in dcns:
        assert not m.conv_offset_mask.weight.any() and not m.conv_offset_mask.bias.any()
        assert m.weight.abs().max() <= 1 / (16 * 9) ** 0.5
        assert m.weight.abs().max() > 0.9 / (16 * 9) ** 0.5
    biases = [m.bias for m in tm.module.modules()
              if isinstance(m, torch.nn.Conv2d) and m.bias is not None]
    assert biases and not any(b.any() for b in biases)
    x, inter = torch.randn(1, 7, 9, 16), torch.randn(1, 7, 9, 16)
    dcn = dcns[0]
    ref = 0.5 * torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), dcn.weight, padding=1)
    torch.testing.assert_close(dcn(x, inter), ref.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-6)


def test_registry_entry_as_jax():
    """At the published width (64 features, 5 groups of 5 blocks): the
    JAX package's params count 6,329,609 and its ``batch_stats`` 384
    (``jax.eval_shape`` of its init)."""
    jm, tm = jax_build_model("airnet"), build_model("airnet", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.param_count() == 6_329_609
    assert sum(b.numel() for b in tm.module.buffers() if b.is_floating_point()) == 384
    assert tm.accepts_train and not build_model("mprnet", device="cpu").accepts_train
