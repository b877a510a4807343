"""Port parity on the CPU: NeurOP (``neurop_re``, ``neurop``, ``neurop_init``)
against the JAX package at a narrow width (``base_nf`` 8, ``encode_nf`` 4).

``neurop_re``'s forward (the strengths and the image) and loss within 1e-5 x
max(1, max|ref|) of the JAX package in float64 and every gradient within
1e-4 x max|ref|, on 300x280 (the encoder's input a bilinear downscale to
256x238 in both axes) and on 40x56; the encoder's resize alone against
``jax.image.resize`` (bilinear, no antialias) down and up; ``neurop_init``
on synthetic ``image_*``/``val_*``/``ref_*`` datapoints (the JAX data
layer builds them for no dataset); the reference names through the JAX
package's own loader; ``configs/neurop_re_fivek_e.py`` (its
``pixel_weight`` taken and ignored, as the JAX package's ``neurop_re`` does) through both
train CLIs for 2 steps; the registry entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax_torch.models.base import build_model
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import assert_close, pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"base_nf": 8, "encode_nf": 4}


def _dp(h, w, n=1, seed=14):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.05, 0.95, (n, h, w, 3)).astype(np.float32)
    return {"image": (ref ** 1.6).astype(np.float32), "ref_image": ref}


def _init_dp(seed=15):
    rng = np.random.default_rng(seed)
    dp = {}
    for k in ("ex", "bc", "vb"):
        dp[f"image_{k}"] = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
        dp[f"ref_{k}"] = rng.uniform(0, 1, (2, 24, 20, 3)).astype(np.float32)
        dp[f"val_{k}"] = rng.uniform(-1, 1, (2,)).astype(np.float32)
    return dp


@pytest.mark.parametrize("h, w", [(300, 280), (40, 56)])
def test_forward_loss_and_gradients_match_jax(h, w, pairs):
    dp = _dp(h, w)
    jm, v, tm = shared_pair(pairs, "neurop_re", _dp(40, 56), **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


@pytest.mark.parametrize("src, dst", [((300, 280), (256, 238)), ((40, 56), (256, 358)),
                                      ((513, 700), (256, 349))])
def test_encoder_resize_matches_jax_bilinear(src, dst):
    x = np.random.default_rng(16).uniform(0, 1, (1, *src, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, *dst, 3), "bilinear", antialias=False)
    out = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    assert_close(out, ref)


def test_init_forward_loss_and_gradients_match_jax(pairs):
    dp = _init_dp()
    jm, v, tm = shared_pair(pairs, "neurop_init", dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


@pytest.mark.parametrize("name", ["neurop_re", "neurop_init"])
def test_bridge_round_trip_under_the_reference_names(name, pairs):
    dp = _dp(40, 56) if name == "neurop_re" else _init_dp()
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_round_trip(tm, v, mappings.neurop_name_map())
    keys = set(tm.module.state_dict())
    want = (["image_encoder.conv1.weight", "ex_renderer.mid_conv.weight",
             "vb_predictor.fc3.weight"] if name == "neurop_re"
            else ["renderer.bc_block.decoder.bias"])
    assert set(want) <= keys


def test_config_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"fivek_e/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.5)), ("ref", (0.2, 1.0)))})
    tiny_config("configs/neurop_re_fivek_e.py", tmp_path / "tiny.py", SMALL)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     _dp(32, 32))
    assert name == "neurop_re"
    assert_clis_agree(jrun, prun, name)


@pytest.mark.parametrize("name, canonical", [("neurop_re", "neurop_re"), ("neurop", "neurop_re"),
                                             ("neurop_init", "neurop_init")])
def test_registry_entries_as_jax(name, canonical):
    jm = jax_build_model(name, pixel_weight=10.0)
    tm = build_model(name, device="cpu", pixel_weight=10.0)
    assert tm.name == jm.name == canonical
    for attr in ("arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
