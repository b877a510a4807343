"""Port parity on the CPU: Zero-Restore's three variants against the JAX package.

Each variant at ``num_channels=16`` (GroupNorm(8) needs a multiple of 8; the
registry builds 64 and ignores its keywords in both packages) on a 64x64
image (the dehaze / UIE trunk's pooled map is 1x1 there, padded by
reflection of a length-1 axis as ``jnp.pad`` does), one set of weights
(numpy draws into the JAX variables' shapes) through the bridge. The JAX
package's clean forward, forward loss with its gradients and 3-step
``make_instance_infer`` fit (lr 1e-3) run in float64 in one jitted call a
variant (``jax_reference``: XLA's compile of the three together is most of
this file's time), and the port is held to them:

  * the float32 forward's ``trans``, ``atm`` and ``enhanced`` within 1e-5 x
    max(1, max|ref|) (``enhanced`` divides by t, so it is held relative to
    its own max|ref|). The JAX package's own float32 forward lies 2e-6 to
    6e-6 from its float64 run and the port's 1e-8 to 5.4e-6, so the two
    float32 runs part by up to 1.07e-5: each is held to the float64 run;
  * the float32 loss (two forwards, ``atm`` not detached) within 1e-5 x
    max(1, |ref|) of the float64 loss, or within 4x the JAX package's own
    float32 loss's gap from it where that is larger (``assert_witnessed``):
    dehaze's 1000 x colour constancy is the square root of near-equal
    channel means' differences, and there the JAX package's float32 loss
    lies 6.9e-4 from its float64, the port's 1.9e-5;
  * the port in float64: the forward and the loss within 1e-12, every
    parameter's gradient within 1e-4 x max|ref| of its tensor, and the fit's
    ``fit_loss`` and ``enhanced`` within 1e-4 x max(1, max|ref|) (they read
    1e-15). A float32 fit is not held to the JAX package's: Adam's first
    step moves each weight by lr x the sign of its gradient, and where a
    gradient is near 0 its sign comes from rounding, so two float32 fits
    part by ~5.6e-4 after 3 steps (measured on the LLIE variant);
  * the reflect pad against ``jnp.pad`` at lengths 1 to 16 and pads 1 to 4;
  * the bridge's round trip (the port's state dict back into the JAX
    variables by the JAX package's own loader, strictly), the three
    registry names' ``Model`` fields against the JAX package's, and the
    predict CLI's ``--config`` with each shipped config (the published
    width, the fit cut to 2 steps) against ``Predictor`` on the same image.
"""

import copy
import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer.engine import make_instance_infer as jax_instance_infer
from enhax.models.base import build_model as jax_build_model
from enhax.models.multitask.zero_restore import ZeroRestoreModule as JaxZeroRestore
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.infer.engine import make_instance_infer
from enhax_torch.models import base as torch_base
from enhax_torch.models.base import build_model
from enhax_torch.models.multitask import zero_restore
from torch_family_parity import check_round_trip
from torch_instance_parity import (TOL_FIT, assert_close, assert_witnessed,  # noqa: F401
                                   drawn_variables, flat_params, jax_float64, one_torch_thread,
                                   to_torch)
from torch_threads import capped_torch_threads  # noqa: F401

VARIANTS = ("llie", "dehaze", "uie")
WIDTH = 16
HW = 64
STEPS = 3
TOL_GRAD = 1e-4


def _datapoint(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0.05, 0.7, (1, HW, HW, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def narrow_pairs():
    """variant -> (JAX model, its variables, the port's model with them,
    the JAX package's float64 reference), each at WIDTH, built once for the
    module."""
    cache = {}

    def get(variant: str):
        if variant not in cache:
            name = f"zero_restore_{variant}"
            dp = _datapoint(VARIANTS.index(variant))
            jm = dataclasses.replace(jax_build_model(name),
                                     module=JaxZeroRestore(num_channels=WIDTH, variant=variant))
            v = drawn_variables(jm, {"image": jnp.asarray(dp["image"])}, seed=7)
            tm = build_model(name, device="cpu")
            tm = dataclasses.replace(tm, module=zero_restore.ZeroRestoreModule(WIDTH, variant))
            tm.module.load_state_dict(jax_to_torch_state_dict(name, flat_params(v)), strict=True)
            assert tm.param_count() == sum(a.size for a in jax.tree_util.tree_leaves(v))
            cache[variant] = (jm, v, tm, dp, jax_reference(jm, v, dp))
        return cache[variant]

    return get


def jax_reference(jm, v, dp: dict) -> dict:
    """The JAX package's clean forward, loss, gradients (the port's names)
    and 3-step fit, in float64, from one jitted call."""
    def bundle(w, d):
        # the loss's outputs are the clean forward's (its first forward)
        (loss, out), grads = jax.value_and_grad(lambda w, d: jm.forward_loss(w, d),
                                                has_aux=True)(w, d)
        fit = jax_instance_infer(jm, STEPS, jm.instance_lr, jm.instance_weight_decay)(
            w, d, jax.random.PRNGKey(0))
        return out, loss, grads, {k: fit[k] for k in ("fit_loss", "enhanced")}

    out, loss, grads, fit = jax_float64(bundle, v, dp)
    loss32 = jax.jit(lambda w, d: jm.forward_loss(w, d)[0])(
        v, {k: jnp.asarray(a) for k, a in dp.items()})
    return {"out": out, "loss": loss, "loss32": np.asarray(loss32), "fit": fit,
            "grads": jax_to_torch_state_dict(jm.name, flat_params(grads))}


def _float64(tm):
    return dataclasses.replace(tm, module=copy.deepcopy(tm.module).double())


def _as64(dp: dict) -> dict:
    return {k: torch.from_numpy(v).double() for k, v in dp.items()}


@pytest.mark.parametrize("n, p", [(1, 1), (2, 1), (3, 2), (5, 4), (2, 3), (16, 3)])
def test_reflect_pad_matches_jnp_pad(n, p):
    x = np.random.default_rng(n * 10 + p).normal(size=(2, 3, n, n + 1)).astype(np.float32)
    ref = jnp.pad(jnp.asarray(x), [(0, 0), (0, 0), (p, p), (p, p)], mode="reflect")
    assert_close(zero_restore.reflect_pad(torch.from_numpy(x), p), ref, 0.0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(narrow_pairs, variant):
    _, _, tm, dp, ref = narrow_pairs(variant)
    with torch.no_grad():
        out = tm.apply(to_torch(dp))
        out64 = _float64(tm).apply(_as64(dp))
    assert set(out) == set(ref["out"]) == {"trans", "atm", "enhanced"}
    for k, r in ref["out"].items():
        assert_close(out[k], r)
        assert_close(out64[k], r, 1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_loss_and_gradients_match_jax(narrow_pairs, variant):
    _, _, tm, dp, ref = narrow_pairs(variant)
    with torch.no_grad():
        loss, _ = tm.forward_loss(to_torch(dp))
    assert_witnessed(loss, ref["loss32"], ref["loss"], key="loss")
    t64 = _float64(tm)
    loss64, _ = t64.forward_loss(_as64(dp))
    loss64.backward()
    assert_close(loss64, ref["loss"], 1e-12)
    grads = dict(t64.module.named_parameters())
    assert set(grads) == set(ref["grads"])
    for k, r in ref["grads"].items():
        g, r = grads[k].grad.numpy(), r.numpy()
        assert np.abs(g - r).max() <= TOL_GRAD * np.abs(r).max(), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_three_step_fit_matches_jax(narrow_pairs, variant):
    jm, _, tm, dp, ref = narrow_pairs(variant)
    out = make_instance_infer(_float64(tm), STEPS, jm.instance_lr, jm.instance_weight_decay)(
        _as64(dp))
    for k, r in ref["fit"].items():
        assert_close(out[k], r, TOL_FIT)
    assert torch.isfinite(out["enhanced"]).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_round_trip(narrow_pairs, variant):
    """The port's state dict (the JAX package's names) back into the JAX
    variables by the JAX package's own loader, strictly, each leaf equal."""
    _, v, tm, _, _ = narrow_pairs(variant)
    check_round_trip(tm, v, {})


@pytest.mark.parametrize("variant", VARIANTS)
def test_registry_entries_as_jax(variant):
    name = f"zero_restore_{variant}"
    jm = jax_build_model(name, num_channels=8)   # both ignore their keywords
    tm = build_model(name, device="cpu", num_channels=8)
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "out_key",
                 "instance_steps", "instance_lr", "instance_weight_decay", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert (jm.module.num_channels, jm.module.variant) == (64, variant)
    assert tm.module.variant == variant
    assert tm.module.estimation.conv_t1.c1.conv.out_channels == 64
    assert tm.forward_loss_fn is not None and tm.loss_fn is None


@pytest.mark.parametrize("variant", VARIANTS)
def test_predict_cli_serves_each_shipped_config(tmp_path, monkeypatch, variant):
    """``--config configs/zero_restore_<variant>.py`` (no ``data``: the
    images come with ``--data``) at the published width on one 64x64 PNG,
    the fit cut to 2 steps by wrapping the ``build_model`` the CLI calls; the
    written image is the ``Predictor``'s output of the same model,
    rounded to 8 bits."""
    from enhax_torch.cli import predict as predict_cli
    from enhax_torch.ops.io import read_image
    rng = np.random.default_rng(4)
    img = (rng.uniform(0.1, 0.6, (HW, HW, 3)) * 255).round().astype(np.uint8)
    (tmp_path / "data").mkdir()
    cv2.imwrite(str(tmp_path / "data" / "a.png"), img)
    built = []

    def two_steps(*args, **kwargs):
        built.append(dataclasses.replace(build_model(*args, **kwargs), instance_steps=2))
        return built[-1]

    monkeypatch.setattr(torch_base, "build_model", two_steps)
    predict_cli.main(["--config", f"configs/zero_restore_{variant}.py", "--data",
                      str(tmp_path / "data"), "--save-dir", str(tmp_path / "out"),
                      "--device", "cpu"])
    (model,) = built
    assert model.name == f"zero_restore_{variant}" and model.param_count() > 0
    assert model.module.estimation.conv_t1.c1.conv.out_channels == 64
    got = read_image(tmp_path / "out" / "a.png")
    out = Predictor(model, device="cpu")({"image": read_image(tmp_path / "data" / "a.png")})
    ref = np.clip(np.round(out["enhanced"][0].numpy() * 255), 0, 255) / 255
    assert got.shape == (HW, HW, 3) and np.isfinite(float(out["fit_loss"]))
    assert np.abs(got - ref).max() <= 1.0 / 255 + 1e-6
