"""Port parity on the CPU: GCENet (``gcenet``, ``gcenet_zsn2n``,
``gcenet_instance``) and its priors against the JAX package.

The full-resolution guided filter, the median blur, the brightness
attention map, the boundary prior (its Sobel magnitude against a float64
evaluation, its thresholded map against the JAX package's with the flips
counted); every name's training forward and loss (``gcenet_zsn2n``'s
three forwards), and a 3-step fit against the JAX package's
(``gcenet_instance`` through both ``Predictor``s, with ``depth`` padded as
the image). Tolerances: 1e-5 x max(1, max|ref|) for ops, forward and loss,
1e-4 x max(1, max|ref|) for the fit; the median exactly; the boundary map's
flips allowed only where the magnitude is within 1e-6 of the threshold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.base import build_model as jax_build_model
from enhax.nn import layers as jlayers
from enhax.ops import filtering as jfilt
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.nn import layers
from enhax_torch.ops import filtering
from torch_instance_parity import assert_close, check_fit, check_forward_loss, datapoint, pair
from torch_instance_parity import one_torch_thread, pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"num_channels": 8, "num_iters": 4}


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("radius, eps", [(3, 1e-4), (1, 1e-2)])
def test_guided_filter_matches_jax(radius, eps):
    y, x = _img((2, 40, 36, 3), 0), _img((2, 40, 36, 3), 1)
    out = filtering.guided_filter(torch.from_numpy(y), torch.from_numpy(x), radius, eps)
    assert_close(out, jfilt.guided_filter(jnp.asarray(y), jnp.asarray(x), radius, eps))


@pytest.mark.parametrize("ksize", [3, 9])
def test_median_blur_and_attention_map_match_jax(ksize):
    x = _img((2, 24, 20, 3), 2)
    assert_close(layers.median_blur(torch.from_numpy(x), ksize),
                 jlayers.median_blur(jnp.asarray(x), ksize), 0.0)
    assert_close(layers.brightness_attention_map(torch.from_numpy(x), 2.6, ksize),
                 jlayers.brightness_attention_map(jnp.asarray(x), 2.6, ksize))


def _magnitude64(x: np.ndarray, normalized: bool) -> np.ndarray:
    """The boundary prior's Sobel magnitude in float64 (replicate padding,
    sqrt(gx^2 + gy^2 + 1e-6), over its maximum)."""
    k = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / (8.0 if normalized else 1.0)
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = x.shape[1:3]
    gx = sum(k[i, j] * xp[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    gy = sum(k[j, i] * xp[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    g = np.sqrt(gx * gx + gy * gy + 1e-6)
    return g / g.max()


@pytest.mark.parametrize("normalized", [False, True])
def test_boundary_prior_matches_jax(normalized):
    """The magnitude within 1e-6 of float64; the map at three thresholds
    against the JAX package's: a flip only where |g - eps| < 1e-6 (none at
    these draws: the count is asserted)."""
    x = _img((2, 32, 28, 1), 3)
    g64 = _magnitude64(x, normalized)
    assert_close(layers.boundary_magnitude(torch.from_numpy(x), normalized), g64, 1e-6)
    flips = 0
    for eps in (0.05, 0.3, 0.6):
        out = layers.boundary_aware_prior(torch.from_numpy(x), eps, normalized).numpy()
        ref = np.asarray(jlayers.boundary_aware_prior(jnp.asarray(x), eps, normalized))
        diff = out != ref
        assert np.all(np.abs(g64[diff] - eps) < 1e-6)
        flips += int(diff.sum())
        assert 0.01 < out.mean() < 0.999
    assert flips == 0


NAMES = ["gcenet", "gcenet_zsn2n", "gcenet_instance"]


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_jax(name, pairs):
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=4)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_forward_loss(jm, v, tm, dp)


def test_forward_without_depth_or_edge_matches_jax():
    """``use_depth=False`` (the image alone, grey edges) and no attention
    map (``bam_gamma=0``: the plain curve loop)."""
    kw = {**SMALL, "use_depth": False, "bam_gamma": 0.0}
    dp = datapoint(jax_build_model("gcenet", **kw), hw=32, seed=5)
    assert set(dp) == {"image"}
    jm, v, tm = pair("gcenet", dp, **kw)
    check_forward_loss(jm, v, tm, dp)


@pytest.mark.parametrize("name, predictor", [("gcenet_instance", True), ("gcenet", False),
                                             ("gcenet_zsn2n", False)])
def test_three_step_fit_matches_jax(name, predictor, pairs):
    """3 AdamW steps (``gcenet_instance``'s lr 5e-5, decay 1e-5; the
    others' Adam at 1e-4). Through the Predictors on 44x40, which pad image
    and depth to 64x64 (reflect) and crop back."""
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=6)
    if predictor:
        dp = {k: v[:, :44, :40] for k, v in dp.items()}
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    if not predictor:
        jm, tm = (dataclasses.replace(m, instance_lr=1e-4) for m in (jm, tm))
    check_fit(jm, v, tm, dp, predictor=predictor)


def test_predictor_requires_depth():
    tm = build_model("gcenet_instance", device="cpu", **SMALL)
    assert tm.required_inputs == ("image", "depth")
    with pytest.raises(ValueError, match="depth"):
        Predictor(dataclasses.replace(tm, instance_steps=1), device="cpu")(
            {"image": _img((1, 32, 32, 3), 7)})


@pytest.mark.parametrize("name", NAMES)
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "instance_steps",
                 "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.module.e_conv1.dw_conv.in_channels == 5
    assert tm.module.e_conv7.pw_conv.out_channels == 3
