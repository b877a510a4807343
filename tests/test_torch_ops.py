"""Port parity: enhax_torch.ops against enhax.ops (CPU, float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.ops import layout as jlayout
from enhax.ops.resize import resize as jax_resize
from enhax.ops.resize import resize_nearest_torch as jax_resize_nearest_torch
from enhax_torch.ops import layout, resize
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-6


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("src, dst", [
    ((64, 48), (8, 6)),     # bilinear down x8
    ((8, 6), (64, 48)),     # bilinear up x8, borders included
    ((37, 37), (16, 16)),   # non-integer ratio
    ((37, 50), (16, 21)),
])
def test_bilinear_resize_matches_jax(rng, src, dst):
    a = rng.uniform(-1, 1, (2, *src, 3)).astype(np.float32)
    j, t = _both(a)
    ref = np.asarray(jax_resize(j, dst, method="bilinear"))
    out = resize.resize(t, dst, method="bilinear").numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


@pytest.mark.parametrize("kwargs", [
    {"size": 24, "side": "short"},
    {"size": 24, "side": "long"},
    {"scale_factor": 0.5},
    {"size": (20, 30), "divisible_by": 8},
    {"divisible_by": 16},
])
def test_resize_size_modes_match_jax(rng, kwargs):
    a = rng.uniform(0, 1, (1, 37, 50, 3)).astype(np.float32)
    j, t = _both(a)
    ref = np.asarray(jax_resize(j, **kwargs))
    out = resize.resize(t, **kwargs).numpy()
    assert out.shape == ref.shape
    # the point here is the target size; at these non-integer ratios jax's
    # scale-and-translate weights and torch's lerp differ in the last bits
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("src, dst", [((37, 50), (16, 21)), ((8, 6), (30, 21))])
def test_nearest_resize_matches_jax(rng, src, dst):
    a = rng.uniform(0, 1, (1, *src, 2)).astype(np.float32)
    j, t = _both(a)
    np.testing.assert_allclose(resize.resize(t, dst, method="nearest").numpy(),
                               np.asarray(jax_resize(j, dst, method="nearest")),
                               atol=TOL)
    np.testing.assert_allclose(resize.resize_nearest_torch(t, dst).numpy(),
                               np.asarray(jax_resize_nearest_torch(j, dst)),
                               atol=TOL)


def test_resize_rejects_unported_method(rng):
    with pytest.raises(ValueError, match="unsupported method"):
        resize.resize(torch.zeros(1, 8, 8, 3), (4, 4), method="bicubic")


@pytest.mark.parametrize("x, d", [(37, 32), (64, 32), (1, 8), (101, 7)])
def test_make_divisible(x, d):
    assert layout.make_divisible(x, d) == jlayout.make_divisible(x, d)


@pytest.mark.parametrize("shape, divisor, mode", [
    ((1, 37, 50, 3), 32, "reflect"),
    ((2, 20, 30, 1), 8, "edge"),
    ((21, 22, 3), 8, "reflect"),
    ((1, 32, 64, 3), 32, "reflect"),
])
def test_pad_to_divisible_and_unpad(rng, shape, divisor, mode):
    a = rng.uniform(0, 1, shape).astype(np.float32)
    j, t = _both(a)
    ref, ref_hw = jlayout.pad_to_divisible(j, divisor, mode=mode)
    out, hw = layout.pad_to_divisible(t, divisor, mode=mode)
    assert hw == ref_hw
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    np.testing.assert_array_equal(layout.unpad(out, hw).numpy(),
                                  np.asarray(jlayout.unpad(ref, ref_hw)))


def test_to_4d():
    for shape, want in (((5, 6), (1, 5, 6, 1)), ((5, 6, 3), (1, 5, 6, 3)),
                        ((2, 5, 6, 3), (2, 5, 6, 3))):
        assert tuple(layout.to_4d(np.zeros(shape)).shape) == want
        assert tuple(jlayout.to_4d(np.zeros(shape)).shape) == want
    with pytest.raises(ValueError):
        layout.to_4d(np.zeros((1, 1, 1, 1, 1)))


def test_image_io_roundtrip_matches_jax(tmp_path, rng):
    from enhax.ops import io as jio
    from enhax_torch.ops import io
    img = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    img[:3, :3] = (1.0, 0.0, 0.0)  # a red patch must stay red (BGR<->RGB)
    io.write_image(tmp_path / "t.png", img)
    jio.write_image(tmp_path / "j.png", img)
    ours = io.read_image(tmp_path / "t.png")
    np.testing.assert_array_equal(ours, jio.read_image(tmp_path / "j.png"))
    np.testing.assert_array_equal(ours[0, 0], (1.0, 0.0, 0.0))
    np.testing.assert_array_equal(io.read_image(tmp_path / "t.png", normalize=False,
                                                to_float=False),
                                  np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8))
