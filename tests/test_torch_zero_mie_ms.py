"""Port parity on the CPU: multi-scale Zero-MIE (``zero_mie_ms`` and its
eight ``_wo_*`` ablations, each with its config) against the JAX package.

Each name is built from its config (``configs/zero_mie_ms_lol_v1.py`` for
``zero_mie_ms``: hsv_d, windows 3/5/7, Fourier features; each ablation's
``configs/zero_mie_ms_wo_*.py``, which zero one loss weight, the depth
gamma or the Fourier features) with the widths cut to hidden 16 and down
size 32. The training forward and every name's loss (the ablations' losses
from the JAX package's ``loss_fn`` on its own forward), the rgb colour
space with the rgb loss and the bilateral denoise, a 3-step fit against
the JAX package's, and the Fourier matrix ``B`` in the fit: out of the
gradient and decayed by AdamW as the JAX package's optimizer decays it.

Tolerances: the forward and the loss 1e-5 x max(1, max|ref|), the outputs
the bicubic fast guided filter gives (enhanced, and the loss) against the
JAX package's forward in float64 within max(1e-5, 4 x its own float32 gap)
(the port takes the filter's window moments in float64); the fit 1e-4 x
max(1, max|ref|); ``B`` after the fit 1e-6 relative.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax_torch.infer.engine import fit_instance
from enhax_torch.models.base import build_model
from enhax_torch.utils.config import load_config
from torch_instance_parity import (assert_close, assert_witnessed, check_fit,
                                   check_forward_loss, datapoint, jax_float64, pair, to_torch)
from torch_instance_parity import one_torch_thread  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CUT = {"hidden_channels": 16, "down_size": 32}
ABLATIONS = [f"zero_mie_ms_wo_{k}" for k in ("color", "depth", "edge", "exp", "ff", "spa",
                                               "spar", "tv")]


def config_kw(name: str) -> dict:
    stem = "zero_mie_ms_lol_v1" if name == "zero_mie_ms" else name
    cfg = load_config(CONFIGS / f"{stem}.py")   # (wo_edge's file names wo_depth as its model)
    return {**cfg["model_cfg"], **CUT}


def test_zero_mie_ms_forward_and_loss_match_jax():
    kw = config_kw("zero_mie_ms")
    dp = datapoint(jax_build_model("zero_mie_ms", **kw), hw=48, seed=0)
    jm, v, tm = pair("zero_mie_ms", dp, **kw)
    assert tm.module.use_ff and tm.module.B.shape == (8, 2)
    check_forward_loss(jm, v, tm, dp, witness=("enhanced", "loss"))


def test_rgb_space_relu_and_denoise_match_jax():
    """The rgb colour space (3 channels read back from the (ds, ds, 3)
    buffer) with the rgb loss (``zero_mie_ms_loss``), ReLU layers, two
    windows and the bilateral denoise of the low-resolution output."""
    kw = {"color_space": "rgb", "loss_hsv": False, "use_denoise": True, "nonlinear": "relu",
          "window_size": [3, 5], **CUT}
    dp = datapoint(jax_build_model("zero_mie_ms", **kw), hw=40, seed=1)
    jm, v, tm = pair("zero_mie_ms", dp, **kw)
    check_forward_loss(jm, v, tm, dp, witness=("enhanced", "loss"))


@pytest.fixture(scope="module")
def ablation_forward():
    """The ablations but ``_wo_ff`` share one module config: the JAX
    forward on their weights, once."""
    kw = config_kw("zero_mie_ms_wo_tv")
    dp = datapoint(jax_build_model("zero_mie_ms_wo_tv", **kw), hw=48, seed=2)
    jm, v, _ = pair("zero_mie_ms_wo_tv", dp, **kw)
    ref = jax.jit(lambda w, d: jm.apply(w, d, training=True))(v, dp)
    witness = jax_float64(lambda w, d: jm.apply(w, d, training=True), v, dp)
    return dp, v, ref, witness


@pytest.mark.parametrize("name", ABLATIONS)
def test_ablation_forward_and_loss_match_jax(name, ablation_forward):
    """Each ablation from its config: the training forward, and its loss
    against the JAX package's ``loss_fn`` of that name on the JAX forward
    (the zeroed weight included)."""
    kw = config_kw(name)
    if name.endswith("_ff"):
        dp = datapoint(jax_build_model(name, **kw), hw=48, seed=2)
        jm, v, tm = pair(name, dp, **kw)
        check_forward_loss(jm, v, tm, dp, witness=("enhanced", "loss"))
        return
    dp, v, ref, witness = ablation_forward
    jm = jax_build_model(name, **kw)
    _, _, tm = pair(name, dp, init="given", variables=v, **kw)
    loss, out = tm.forward_loss(to_torch(dp))
    for k, r in ref.items():
        if k == "enhanced":
            assert_witnessed(out[k], r, witness[k], key=k)
        else:
            assert_close(out[k], r)
    ref_loss = jm.loss_fn(ref, {k: jnp.asarray(a) for k, a in dp.items()})
    assert_witnessed(loss, ref_loss, float(jm.loss_fn(witness, dp)), key="loss")


@pytest.mark.parametrize("name", ["zero_mie_ms", "zero_mie_ms_wo_ff"])
def test_three_step_fit_matches_jax(name):
    """3 AdamW steps (lr 1e-5, decay 3e-4) from the config, with and
    without Fourier features. The other seven ablations build
    ``zero_mie_ms``'s module and differ from it only in their loss weights,
    which ``test_ablation_forward_and_loss_match_jax`` holds name by name:
    their fits are this fit under another weighting (a JAX fit compiles in
    about 10 s on the CPU, and tier-1's time is kept for the rest)."""
    kw = config_kw(name)
    dp = datapoint(jax_build_model(name, **kw), hw=48, seed=3)
    jm, v, tm = pair(name, dp, **kw)
    check_fit(jm, v, tm, dp)


def test_fourier_matrix_in_the_fit():
    """``B`` gets no gradient (detached, as the JAX package's
    ``stop_gradient``) and is decayed by AdamW all the same: after 3 steps
    at lr 1e-2, decay 0.5 it is the JAX package's optimizer's B (optax.adamw
    on its zero gradient), and it moved."""
    kw = config_kw("zero_mie_ms")
    dp = datapoint(jax_build_model("zero_mie_ms", **kw), hw=32, seed=4)
    jm, v, tm = pair("zero_mie_ms", dp, **kw)
    fit, _ = fit_instance(tm, to_torch(dp), 3, lr=1e-2, weight_decay=0.5)
    tx = optax.adamw(1e-2, weight_decay=0.5)
    b = {"B": v["params"]["B"]}
    state = tx.init(b)
    for _ in range(3):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.zeros_like, b), state, b)
        b = optax.apply_updates(b, upd)
    assert_close(fit.module.B.detach(), b["B"], 1e-6)
    assert not torch.equal(fit.module.B, tm.module.B)
    torch_b = tm.module.B
    loss, _ = tm.forward_loss(to_torch(dp))
    loss.backward()
    assert torch_b.grad is None


@pytest.mark.parametrize("name", ["zero_mie_ms"] + ABLATIONS)
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("arch", "tasks", "schemes", "required_inputs", "optional_inputs",
                 "instance_steps", "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.module.window_size == (3, 5, 7) and tm.module.color_space == "hsv"
