"""Port parity on the CPU: the modulated deformable convolution (DCNv2,
``enhax_torch/nn/deform.py``) against the JAX package's
``enhax/nn/deform.py::modulated_deform_conv2d``.

The forward in float32 within 1e-5 x max(1, max|ref|), and the gradients
of x, offset, mask and weight in float64 (the JAX package under
``jax.enable_x64``) within 1e-4 x max|ref|, at ragged sizes and 1x1, 3x3
and (the forward) 5x5 kernels, with offsets that are fractional, exact integers (the
floor's boundary), beyond +-1 px, and that leave the map (every corner of
such a sample zeroed on its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.nn.deform import modulated_deform_conv2d as jax_dcn
from enhax_torch.nn.deform import modulated_deform_conv2d
from torch_instance_parity import assert_close
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_GRAD = 1e-4


def _draw(shape, cout, k, kind, seed, bias=False):
    """x (B, H, W, C), offset, mask, the JAX weight (k, k, C, Cout) and
    bias; offsets by ``kind``."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape)
    off_shape = (b, h, w, 2 * k * k)
    if kind == "fractional":
        off = rng.uniform(-0.95, 0.95, off_shape)
    elif kind == "integer":
        off = rng.integers(-2, 3, off_shape).astype(np.float64)
    elif kind == "beyond":
        off = rng.uniform(1.0, 3.5, off_shape) * rng.choice([-1.0, 1.0], off_shape)
    else:   # "outside": samples past every border, some of them far
        off = rng.uniform(-1.5, 1.5, off_shape)
        off[:, :2, :, 0::2] -= 3.0        # rows above the map
        off[:, -2:, :, 0::2] += 3.0       # and below it
        off[:, :, :2, 1::2] -= 2.5        # columns left of it
        off[:, :, -1:, 1::2] += 40.0      # and far right of it
    mask = rng.uniform(0, 1, (b, h, w, k * k))
    weight = rng.normal(0, 1 / np.sqrt(c * k * k), (k, k, c, cout))
    bvec = rng.normal(0, 0.1, (cout,)) if bias else None
    return x, off, mask, weight, bvec


def _torch_args(arrays, dtype):
    x, off, mask, weight, bvec = arrays
    out = [torch.tensor(a, dtype=dtype) for a in (x, off, mask)]
    out.append(torch.tensor(weight.transpose(3, 2, 0, 1), dtype=dtype))
    out.append(None if bvec is None else torch.tensor(bvec, dtype=dtype))
    return out


CASES = [((2, 7, 9, 5), 4, 3), ((1, 13, 6, 8), 8, 3), ((1, 5, 11, 3), 2, 5),
         ((2, 4, 4, 6), 5, 1)]
KINDS = ["fractional", "integer", "beyond", "outside"]
# jitted once a shape, and shared by the kinds of offsets
_jax_forward = jax.jit(jax_dcn)


@jax.jit
def _jax_grads(x, off, mask, weight, g):
    return jax.grad(lambda *a: jnp.sum(jax_dcn(*a) * g), argnums=(0, 1, 2, 3))(
        x, off, mask, weight)


@pytest.mark.parametrize("shape, cout, k", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(shape, cout, k, kind):
    arrays = _draw(shape, cout, k, kind, seed=len(kind) + shape[1], bias=kind == "beyond")
    x, off, mask, weight, bvec = (None if a is None else np.asarray(a, np.float32)
                                  for a in arrays)
    ref = _jax_forward(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                       jnp.asarray(weight), None if bvec is None else jnp.asarray(bvec))
    out = modulated_deform_conv2d(*_torch_args((x, off, mask, weight, bvec), torch.float32))
    assert out.shape == shape[:3] + (cout,)
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("shape, cout, k", CASES[:2] + CASES[3:])   # 5x5: 14 s of XLA
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_in_float64(shape, cout, k, kind):
    """The gradients of sum(out * g) for a drawn g: x's (the gather's
    scatter-add), the offsets' (the bilinear weights' slopes, 0 through the
    floor), the masks' and the weight's."""
    x, off, mask, weight, _ = _draw(shape, cout, k, kind, seed=7 + len(kind))
    g = np.random.default_rng(3).normal(0, 1, shape[:3] + (cout,))
    with jax.enable_x64(True):
        refs = _jax_grads(*(jnp.asarray(a, jnp.float64) for a in (x, off, mask, weight, g)))
        refs = [np.asarray(r, np.float64) for r in refs]
    args = [t.requires_grad_(True) for t in _torch_args((x, off, mask, weight, None),
                                                        torch.float64)[:4]]
    (modulated_deform_conv2d(*args) * torch.from_numpy(g)).sum().backward()
    grads = [a.grad.numpy() for a in args]
    grads[3] = grads[3].transpose(2, 3, 1, 0)   # torch (Cout, C, k, k) -> (k, k, C, Cout)
    for name, got, ref in zip(("x", "offset", "mask", "weight"), grads, refs):
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert float(np.abs(got - ref).max()) <= TOL_GRAD * scale, name


def test_a_sample_outside_the_map_reads_zero():
    """Each corner is zeroed on its own: a sample half a pixel above the
    first row reads half of that row; one a pixel and more out reads 0."""
    x = torch.arange(1, 13, dtype=torch.float32).reshape(1, 3, 4, 1)
    weight = torch.ones(1, 1, 1, 1)
    mask = torch.ones(1, 3, 4, 1)
    off = torch.zeros(1, 3, 4, 2)
    off[..., 0] = -0.5
    out = modulated_deform_conv2d(x, off, mask, weight)[0, :, :, 0]
    assert torch.allclose(out[0], 0.5 * x[0, 0, :, 0])
    assert torch.allclose(out[1:], 0.5 * (x[0, :-1, :, 0] + x[0, 1:, :, 0]))
    off[..., 0] = -5.0
    assert modulated_deform_conv2d(x, off, mask, weight).abs().max() == 0
