"""Port parity on the CPU: Zero-DiDCE and SGZ against the JAX package at
narrow widths (8 features) on 36x36 to 64x64.

The training forward, the loss and every gradient (``check_forward_loss_grads``:
forward and loss within 1e-5 x max(1, max|ref|) in float32, gradients
within 1e-4 x max|ref| in float64); Zero-DiDCE's number of curve steps in
each of its three branches of the mean, and its means over the whole batch
(a batch of two is not two requests); SGZ's serving forward through the
curve kernel's plain version, at a size that is not a multiple of its
divisor (12) through both packages' ``Predictor``; the bridge (SGZ's
reference names through the JAX package's own loader, Zero-DiDCE's flat
names); SGZ through both train CLIs for 2 steps on a fabricated tree (a
config written here); the registry entries."""

import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.infer.engine import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import sgz as tsgz
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis)
from torch_instance_parity import assert_close, pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"num_channels": 8}


def _dp(n=1, hw=48, seed=3, lo=0.02, hi=0.5):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(lo, hi, (n, hw, hw, 3)).astype(np.float32)}


@pytest.mark.parametrize("name, hw", [("zero_didce", 40), ("sgz", 48), ("sgz", 50)])
def test_forward_loss_and_gradients_match_jax(pairs, name, hw):
    dp = _dp(hw=hw)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


def _jax_steps(mean: float) -> int:
    """Zero-DiDCE's step count at a batch mean, as the JAX module computes it."""
    s = mean * mean
    b = (-25.0 * mean + 10.0 if mean < 0.1 else
         17.14 * s - 15.14 * mean + 10.0 if mean < 0.45 else 5.66 * s - 2.93 * mean + 7.2)
    return min(int(np.floor(b)), 12)


@pytest.mark.parametrize("lo, hi", [(0.0, 0.1), (0.1, 0.5), (0.45, 0.95)])
def test_zero_didce_each_branch_of_the_step_count(pairs, lo, hi):
    """Dark (mean < 0.1), dim and bright images: the step count of each
    branch, and the enhanced image against the JAX package's."""
    dp = _dp(hw=36, seed=4, lo=lo, hi=hi)
    jm, v, tm = shared_pair(pairs, "zero_didce", dp, **SMALL)
    mean = float(dp["image"].mean())
    steps = _jax_steps(mean)
    assert {(0.0, 0.1): mean < 0.1, (0.1, 0.5): 0.1 <= mean < 0.45,
            (0.45, 0.95): mean >= 0.45}[(lo, hi)]
    ref = jm.apply(v, {"image": dp["image"]})
    with torch.no_grad():
        out = tm.apply({"image": torch.from_numpy(dp["image"])})
    assert_close(out["enhanced"], ref["enhanced"])
    # the count by the curve's own algebra: y after the loop equals y after
    # ``steps`` unmasked steps
    y = torch.from_numpy(dp["image"])
    r = out["adjust"]
    n3 = -0.79 * mean ** 2 + 0.81 * mean + 1.4
    for _ in range(steps):
        ym = y.mean()
        y = y + r * (y * y - y) * ((0.63 - ym) / (n3 - ym))
    assert_close(out["enhanced"], y.numpy(), 1e-5)


def test_zero_didce_takes_its_means_over_the_whole_batch(pairs):
    """A dark and a bright image in one batch share one step count and one
    gain a step, from the batch's mean, as in the JAX package: the batch's
    output is not the two images' outputs alone."""
    dark, bright = _dp(hw=36, seed=5, lo=0.0, hi=0.1), _dp(hw=36, seed=6, lo=0.5, hi=0.95)
    batch = {"image": np.concatenate([dark["image"], bright["image"]])}
    jm, v, tm = shared_pair(pairs, "zero_didce", batch, **SMALL)
    ref = jm.apply(v, batch)["enhanced"]
    with torch.no_grad():
        out = tm.apply({"image": torch.from_numpy(batch["image"])})["enhanced"]
        alone = torch.cat([tm.apply({"image": torch.from_numpy(d["image"])})["enhanced"]
                           for d in (dark, bright)])
    assert_close(out, ref)
    assert _jax_steps(float(batch["image"].mean())) != _jax_steps(float(dark["image"].mean()))
    assert float((out - alone).abs().max()) > 1e-2


def test_sgz_serving_pads_to_its_divisor_and_matches_jax(pairs):
    """A 50x62 request: both Predictors pad to 60x72 (multiples of 12),
    downscale to 5x6, upsample the curve corner-aligned and crop; the port
    through ``fused_curve_apply``'s plain version on the CPU."""
    x = np.random.default_rng(7).uniform(0.02, 0.5, (50, 62, 3)).astype(np.float32)
    jm, v, tm = shared_pair(pairs, "sgz", _dp(), **SMALL)
    ref = JaxPredictor(jm, variables=v)({"image": x})
    out = Predictor(tm, device="cpu")({"image": x})
    assert tuple(out["enhanced"].shape) == (1, 50, 62, 3)
    for k in ("enhanced", "adjust"):
        assert_close(out[k], ref[k])


def test_sgz_curve_is_corner_aligned():
    """The curve's upsample is ``align_corners=True``: its corners are the
    low-resolution curve's corners."""
    tm = build_model("sgz", device="cpu", **SMALL)
    x = torch.from_numpy(_dp(hw=48)["image"])
    with torch.no_grad():
        r = tm.apply({"image": x})["adjust"]
        m = tm.module
        xd = tsgz.resize(x, (4, 4))
        x1 = torch.relu(m.e_conv1(xd.permute(0, 3, 1, 2)))
        x2 = torch.relu(m.e_conv2(x1))
        x3 = torch.relu(m.e_conv3(x2))
        x4 = torch.relu(m.e_conv4(x3))
        x5 = torch.relu(m.e_conv5(torch.cat([x3, x4], 1)))
        x6 = torch.relu(m.e_conv6(torch.cat([x2, x5], 1)))
        lr = torch.tanh(m.e_conv7(torch.cat([x1, x6], 1))).permute(0, 2, 3, 1)
    for (i, j), (a, b) in {(0, 0): (0, 0), (0, -1): (0, -1), (-1, 0): (-1, 0),
                           (-1, -1): (-1, -1)}.items():
        torch.testing.assert_close(r[:, i, j], lr[:, a, b], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sgz", "zero_didce"])
def test_bridge_round_trip(pairs, name):
    jm, v, tm = shared_pair(pairs, name, _dp(), **SMALL)
    keys = set(tm.module.state_dict())
    if name == "sgz":
        for k in ("e_conv1.depth_conv.weight", "e_conv1.point_conv.bias",
                  "e_conv7.point_conv.weight"):
            assert k in keys, k
        check_round_trip(tm, v, mappings.sgz_name_map())
    else:
        assert keys == {f"e_conv{i}.{p}" for i in (1, 2, 3, 7) for p in ("weight", "bias")}
        check_round_trip(tm, v, {})


def test_sgz_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"sice_mix/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.4)), ("ref", (0.2, 1.0)))})
    config = tmp_path / "sgz_tiny.py"
    config.write_text("model = 'sgz'\n"
                      f"model_cfg = {SMALL!r}\n"
                      "data = 'sice_mix'\n"
                      "data_cfg = {'batch_size': 2, 'shuffle': True}\n"
                      "image_size = 32\n"
                      "optimizer_cfg = {'optimizer': {'name': 'adam', 'lr': 1e-4, "
                      "'weight_decay': 1e-4}}\n"
                      "trainer_cfg = {'max_epochs': 2, 'limit_val_batches': 0, "
                      "'gradient_clip_val': 0.1}\n"
                      "seed = 3\n")
    example = {**_dp(2, 32), "ref_image": _dp(2, 32)["image"]}
    jrun, prun, name = run_both_clis(config, root, tmp_path, monkeypatch, example)
    assert name == "sgz"
    assert_clis_agree(jrun, prun, name)


@pytest.mark.parametrize("name", ["zero_didce", "sgz"])
def test_registry_entry_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor",
                 "instance_steps"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.loss_fn is not None
