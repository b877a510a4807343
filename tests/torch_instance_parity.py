"""Helpers of the instance models' parity tests: the JAX package against the
port on the CPU, one set of weights shared through the bridge.

``pair(name, **kw)`` builds a registered model in both packages with the
JAX package's weights (its own init, jitted, or numpy draws into the shapes
of its variables tree) loaded into the port by ``jax_to_torch_state_dict``.
``check_forward_loss`` holds the port's training forward and loss to the
JAX package's; ``check_fit`` holds a 3-step ``make_instance_infer`` fit
(``Predictor`` on request) to the JAX package's of the same steps (in
float64 where the forward needs the witness).

Tolerances: the forward and the loss 1e-5 x max(1, max|ref|) (``TOL``), the
fit 1e-4 x max(1, max|ref|) (``TOL_FIT``). Where float32 cancels (the
guided filters' window moments, FINER's large sine arguments), an output is
held to the JAX package's own function evaluated in float64
(``jax.enable_x64``) instead: within max(tol, ``FACTOR`` x the JAX
package's own float32 gap from that witness), and the JAX package's gap is
asserted under ``JAX_GAP_MAX`` so that the witness is the same function.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer.engine import Predictor as JaxPredictor
from enhax.infer.engine import make_instance_infer as jax_instance_infer
from enhax.models.base import build_model as jax_build_model
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.infer.engine import make_instance_infer
from enhax_torch.models.base import build_model

TOL = 1e-5
TOL_FIT = 1e-4
FACTOR = 4.0          # the port against the float64 witness: within 4x JAX's own gap
JAX_GAP_MAX = 1e-2    # JAX's float32 against its float64: the same function


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's ops on these small tensors on one thread: across threads
    a 3-step fit takes 30x longer here, and tier-1's workers share the
    cores. Imported by each test module, so it applies to theirs alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(out, ref) -> float:
    """max|out - ref| / max(1, max|ref|)."""
    out = out.detach().double().numpy() if isinstance(out, torch.Tensor) else np.asarray(
        out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))


def assert_close(out, ref, tol: float = TOL) -> float:
    err = rel_err(out, ref)
    assert err <= tol, err
    return err


def assert_witnessed(out, ref32, ref64, tol: float = TOL, key: str = "") -> tuple:
    """The port within max(tol, FACTOR x JAX's float32 gap) of the float64
    witness; JAX's gap under JAX_GAP_MAX."""
    gap = rel_err(ref32, ref64)
    err = rel_err(out, ref64)
    assert gap <= JAX_GAP_MAX, (key, gap)
    assert err <= max(tol, FACTOR * gap), (key, err, gap)
    return err, gap


def flat_params(variables) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}


def drawn_variables(jm, dp: dict, seed: int):
    """numpy draws into the shapes of ``jm``'s variables (``jax.eval_shape``
    of its init, nothing compiled): kernels N(0, 1/fan_in), biases and BN
    offsets and means small, BN scales and variances near 1."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), dp)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif leaf == "scale":
            a = 1 + rng.normal(0, 0.05, s.shape)
        elif leaf == "var":
            a = 1 + np.abs(rng.normal(0, 0.1, s.shape))
        else:   # bias, mean
            a = rng.normal(0, 0.02, s.shape)
        return jnp.asarray(a, s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def datapoint(jm, hw: int = 64, seed: int = 0, lo: float = 0.05, hi: float = 0.6) -> dict:
    """Image (1, hw, hw, 3) uniform in [lo, hi]; a depth map (a ramp and
    noise) where the model takes one."""
    rng = np.random.default_rng(seed)
    dp = {"image": rng.uniform(lo, hi, (1, hw, hw, 3)).astype(np.float32)}
    if "depth" in jm.required_inputs or "depth" in jm.optional_inputs:
        ramp = np.linspace(0.1, 0.9, hw, dtype=np.float32)[None, :, None, None]
        dp["depth"] = np.clip(ramp + rng.normal(0, 0.05, (1, hw, hw, 1)), 0, 1).astype(
            np.float32)
    return dp


def pair(name: str, dp: dict, init: str = "jax", seed: int = 1, variables=None,
         **kw) -> tuple:
    """(JAX model, its variables, the port's model with those weights): the
    JAX init's (``init="jax"``), numpy draws (``"numpy"``) or ``variables``
    (``"given"``)."""
    jm = jax_build_model(name, **kw)
    jdp = {k: jnp.asarray(v) for k, v in dp.items()}
    if init == "jax":
        v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jdp)
    elif init == "numpy":
        v = drawn_variables(jm, jdp, seed)
    else:
        v = variables
    tm = build_model(name, device="cpu", **kw)
    tm.module.load_state_dict(jax_to_torch_state_dict(name, flat_params(v)), strict=True)
    # the JAX variables hold BatchNorm statistics the port keeps as buffers
    buffers = sum(b.numel() for b in tm.module.buffers() if b.is_floating_point())
    assert tm.param_count() + buffers == sum(a.size for a in jax.tree_util.tree_leaves(v))
    return jm, v, tm


@pytest.fixture(scope="module")
def pairs():
    """A module's ``pair`` results, built once a (name, keywords) and
    shared by its tests (``shared_pair``): the JAX init traces for
    seconds."""
    return {}


def shared_pair(cache: dict, name: str, dp: dict, **kw) -> tuple:
    """``pair(name, dp, **kw)`` from ``cache`` (the variables' shapes do
    not depend on the image size)."""
    key = (name, tuple(sorted((k, repr(v)) for k, v in kw.items())), tuple(sorted(dp)))
    if key not in cache:
        cache[key] = pair(name, dp, **kw)
    return cache[key]


def to_torch(dp: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in dp.items()}


def jax_float64(fn, *trees):
    """``fn`` (of the JAX package) on ``trees`` in float64: the witness."""
    with jax.enable_x64(True):
        out = jax.jit(fn)(*[jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
                            for t in trees])
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), out)


def check_forward_loss(jm, v, tm, dp: dict, witness: tuple = ()) -> dict:
    """The port's training forward and loss (``forward_loss``) against the
    JAX package's: every output of the JAX forward, same key set; the keys
    in ``witness`` (and "loss") against the float64 witness. Returns the
    errors."""
    ref_loss, ref = jax.jit(lambda w, d: jm.forward_loss(w, d))(v, dp)
    loss, out = tm.forward_loss(to_torch(dp))
    ref = {k: r for k, r in ref.items() if r is not None}
    assert {k for k, o in out.items() if o is not None} == set(ref)
    wl = wo = None
    if witness:
        wl, wo = jax_float64(lambda w, d: jm.forward_loss(w, d), v, dp)
    errs = {}
    for k, r in [("loss", ref_loss)] + sorted(ref.items()):
        o = loss if k == "loss" else out[k]
        if witness and (k in witness or k == "loss" and "loss" in witness):
            errs[k] = assert_witnessed(o, r, wl if k == "loss" else wo[k], key=k)
        else:
            errs[k] = assert_close(o, r)
    return errs


def check_fit(jm, v, tm, dp: dict, steps: int = 3, witness: str | None = None,
              predictor: bool = False, keys: tuple = ("fit_loss", "enhanced")) -> dict:
    """A ``steps``-step fit of the port (``make_instance_infer``, or
    ``Predictor`` with ``instance_steps = steps``) against the JAX
    package's of the same steps: ``keys`` within TOL_FIT. With ``witness``
    against the JAX package's fit in float64: ``"f64"`` within TOL_FIT
    (the JAX float32 forward's gap is asserted where the model's forward is
    checked), ``"gap"`` within max(TOL_FIT, FACTOR x the JAX float32 fit's
    own gap) (``assert_witnessed``)."""
    args = (steps, jm.instance_lr, jm.instance_weight_decay)

    def jax_fit(var, d):
        return jax_instance_infer(jm, *args)(var, d, jax.random.PRNGKey(0))

    if predictor:
        ref = JaxPredictor(dataclasses.replace(jm, instance_steps=steps), variables=v)(dp)
        out = Predictor(dataclasses.replace(tm, instance_steps=steps), device="cpu")(dp)
    else:
        ref = jax_float64(jax_fit, v, dp) if witness == "f64" else jax_fit(v, dp)
        out = make_instance_infer(tm, *args)(to_torch(dp))
    if witness == "gap":
        w = jax_float64(jax_fit, v, dp)
        errs = {k: assert_witnessed(out[k], ref[k], w[k], TOL_FIT, k) for k in keys}
    else:
        errs = {k: assert_close(out[k], ref[k], TOL_FIT) for k in keys}
    assert torch.isfinite(out["enhanced"]).all()
    return errs
