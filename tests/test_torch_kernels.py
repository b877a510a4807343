"""Port parity: the curve kernels' plain versions against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in Pallas interpret mode, as tests/test_kernels.py runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.kernels import dce_curve as jdce
from enhax.models.llie.zero_dce import apply_curves as japply_curves
from enhax_torch.kernels import dce_curve
from torch_threads import capped_torch_threads  # noqa: F401


@pytest.mark.parametrize("shared, rc", [(False, 24), (True, 3)])
def test_apply_curves_matches_jax(rng, shared, rc):
    x = rng.uniform(0, 0.5, (2, 9, 13, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (2, 9, 13, rc)).astype(np.float32)
    ref = np.asarray(japply_curves(jnp.asarray(x), jnp.asarray(r), 8, shared))
    out = dce_curve.apply_curves(torch.from_numpy(x), torch.from_numpy(r), 8, shared)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("shared, rc, shape, iters, atol", [
    pytest.param(False, 24, (2, 16, 32, 3), 8, 1e-6, id="False-24"),
    pytest.param(True, 3, (2, 16, 32, 3), 8, 1e-6, id="True-3"),
    # zero_dce_v's instance shape: C = 1, 15 per-iteration curves. Over 15
    # steps the two float32 loops part by more than 1e-6 (XLA contracts
    # y + r(y^2 - y) into fused multiply-adds, torch rounds every op; the
    # step's slope reaches 2), each about 1e-6 from float64 here: held at
    # 1e-5, as the upsample kernel against JAX
    pytest.param(False, 15, (1, 256, 256, 1), 15, 1e-5, id="instance-C1-15"),
    # 35 pixels: not a multiple of the "vec" path's 8 (or 4) pixels a thread
    pytest.param(False, 24, (1, 5, 7, 3), 8, 1e-6, id="35-pixels"),
])
def test_fused_curve_apply_plain_matches_jax_kernel(rng, shared, rc, shape, iters, atol):
    x = rng.uniform(0, 0.5, shape).astype(np.float32)
    r = rng.uniform(-1, 1, shape[:3] + (rc,)).astype(np.float32)
    ref = np.asarray(jdce.fused_curve_apply(jnp.asarray(x), jnp.asarray(r), iters, shared,
                                            interpret=True))
    out = dce_curve.fused_curve_apply(torch.from_numpy(x), torch.from_numpy(r),
                                      num_iters=iters, shared=shared)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)
    assert dce_curve.fused_curve_apply.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("scale", [4, 8])
def test_fused_curve_upsample_plain_matches_jax_kernel(rng, scale):
    """The whole array, borders included: the edge-clamped interpolation
    must match the TPU kernel's prev/cur/next row views."""
    x = rng.uniform(0, 0.5, (1, 32, 64, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (1, 32 // scale, 64 // scale, 3)).astype(np.float32)
    ref = np.asarray(jdce.fused_curve_upsample_apply(
        jnp.asarray(x), jnp.asarray(r), num_iters=8, scale=scale, interpret=True))
    out = dce_curve.fused_curve_upsample_apply(torch.from_numpy(x), torch.from_numpy(r),
                                               num_iters=8, scale=scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert dce_curve.fused_curve_upsample_apply.launches == 0


def test_upsample_rejects_non_multiple():
    x = torch.zeros(1, 30, 32, 3)
    with pytest.raises(ValueError, match="multiples of scale=4"):
        dce_curve.fused_curve_upsample_apply(x, torch.zeros(1, 7, 8, 3), scale=4)
    with pytest.raises(ValueError, match="multiples of scale=4"):
        jdce.fused_curve_upsample_apply(jnp.zeros((1, 30, 32, 3)),
                                        jnp.zeros((1, 7, 8, 3)), scale=4,
                                        interpret=True)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape", "lr_shape",
                                  "contiguity", "rank"])
def test_wrappers_check_their_inputs(case):
    x = torch.zeros(1, 8, 8, 3)
    r = torch.zeros(1, 8, 8, 24)
    lr = torch.zeros(1, 2, 2, 3)
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            dce_curve.fused_curve_apply(x.half(), r.half())
        elif case == "mixed_dtype":
            dce_curve.fused_curve_upsample_apply(x, lr.bfloat16(), scale=4)
        elif case == "shape":
            dce_curve.fused_curve_apply(x, r[..., :12])
        elif case == "lr_shape":
            dce_curve.fused_curve_upsample_apply(x, torch.zeros(1, 4, 4, 3), scale=4)
        elif case == "contiguity":
            dce_curve.fused_curve_apply(x.transpose(1, 2), r.transpose(1, 2))
        else:
            dce_curve.fused_curve_apply(x[0], r[0])


@pytest.mark.parametrize("fn, args", [
    ("fused_curve_apply", ((2, 5, 7, 3), (2, 5, 7, 24))),
    ("fused_curve_upsample_apply", ((2, 8, 16, 3), (2, 2, 4, 3))),
])
def test_plain_versions_in_bf16_carry_y_in_float32(rng, fn, args):
    """In bfloat16 the plain versions read the curve in bfloat16, carry y in
    float32 and round once: they stay within one bfloat16 step of float32."""
    x = torch.from_numpy(rng.uniform(0, 1, args[0]).astype(np.float32))
    r = torch.from_numpy(rng.uniform(-1, 1, args[1]).astype(np.float32))
    wrapper = getattr(dce_curve, fn)
    out = wrapper(x.bfloat16(), r.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = wrapper(x.bfloat16().float(), r.bfloat16().float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2**-8)


def _u8_levels(a: np.ndarray) -> np.ndarray:
    return np.clip(np.round(a * 255), 0, 255)


@pytest.mark.parametrize("scale", [4, 8])
def test_fused_curve_upsample_bf16_rounds_at_other_places_than_jax(rng, scale):
    """In bfloat16 the TPU kernel rounds at three places the port does not:
    the W pass (enhax/kernels/dce_curve.py:106-107), the H lerp done in
    bf16 (:131) and y after every curve step (:133-134); the port carries
    the interpolation and y in float32 and rounds the curve and the output
    once. On the same bf16 inputs, against the TPU kernel in float32 on
    those inputs as the reference, in uint8 levels (x255, round, clip):
    the port is within 4 levels of JAX's bf16 output (measured 4 at
    x ~ U(0, 0.5)), within 2 of float32 (one bf16 step of the output
    and one of the curve), and no further from float32 than JAX's bf16
    output is (measured 4 levels). A deliberate difference: the port does
    not copy JAX's rounding."""
    x = rng.uniform(0, 0.5, (2, 64, 128, 3)).astype(np.float32)
    r = rng.uniform(-1, 1, (2, 64 // scale, 128 // scale, 3)).astype(np.float32)
    xb, rb = torch.from_numpy(x).bfloat16(), torch.from_numpy(r).bfloat16()
    xf, rf = xb.float().numpy(), rb.float().numpy()
    jax_bf16 = np.asarray(jdce.fused_curve_upsample_apply(
        jnp.asarray(xf, jnp.bfloat16), jnp.asarray(rf, jnp.bfloat16), num_iters=8,
        scale=scale, interpret=True).astype(jnp.float32))
    f32 = np.asarray(jdce.fused_curve_upsample_apply(
        jnp.asarray(xf), jnp.asarray(rf), num_iters=8, scale=scale, interpret=True))
    port = dce_curve.fused_curve_upsample_apply(xb, rb, num_iters=8, scale=scale)
    assert port.dtype == torch.bfloat16
    port = port.float().numpy()
    assert np.abs(_u8_levels(port) - _u8_levels(jax_bf16)).max() <= 4
    assert np.abs(_u8_levels(port) - _u8_levels(f32)).max() <= 2
    assert np.abs(port - f32).max() <= np.abs(jax_bf16 - f32).max()


@pytest.mark.parametrize("shape, dtype, scale, ptr, path", [
    ((48, 1088, 1920, 3), torch.bfloat16, 8, 0, "vec"),    # the bench chunk
    ((1, 608, 832, 3), torch.bfloat16, 4, 512, "vec"),     # a request padded to 32
    ((2, 16, 8, 3), torch.float32, 2, 16, "vec"),
    ((2, 36, 52, 3), torch.float32, 4, 0, "general"),      # W % 8 != 0
    ((2, 40, 72, 4), torch.bfloat16, 8, 0, "general"),     # C != 3
    ((1, 18, 24, 3), torch.float32, 3, 0, "general"),      # scale not 2, 4 or 8
    ((1, 32, 32, 3), torch.bfloat16, 16, 0, "general"),
    ((1, 32, 32, 3), torch.bfloat16, 8, 4, "general"),     # base 2 elements off 16 bytes
    ((1, 32, 32, 3), torch.float32, 8, 8, "general"),
])
def test_upsample_path_choices(shape, dtype, scale, ptr, path):
    assert dce_curve.upsample_path(shape, dtype, scale, ptr) == path


def test_upsample_on_cpu_counts_no_path():
    before = dict(dce_curve.fused_curve_upsample_apply.path_launches)
    dce_curve.fused_curve_upsample_apply(torch.zeros(1, 16, 16, 3), torch.zeros(1, 2, 2, 3),
                                         scale=8)
    assert dce_curve.fused_curve_upsample_apply.path_launches == before


# ptrs: image, curves, output; 4 bytes is 2 bf16 elements off 16-byte alignment
@pytest.mark.parametrize("shape, dtype, shared, ptrs, iters, path", [
    ((4, 1092, 1920, 3), torch.bfloat16, True, (0, 512, 1024), 8, "vec"),   # SGZ's batch
    ((4, 1092, 1920, 3), torch.float32, True, (16, 32, 48), 8, "vec"),
    ((1, 7, 13, 4), torch.bfloat16, True, (0, 0, 0), 8, "vec"),             # a shared curve: any C
    ((4, 1092, 1920, 3), torch.bfloat16, True, (4, 0, 0), 8, "general"),    # image off by 2
    ((4, 1092, 1920, 3), torch.bfloat16, True, (0, 4, 0), 8, "general"),    # curves off by 2
    ((4, 1092, 1920, 3), torch.bfloat16, True, (0, 0, 4), 8, "general"),    # output off by 2
    ((4, 1092, 1920, 3), torch.float32, True, (8, 0, 0), 8, "general"),
    ((1, 1088, 1920, 3), torch.bfloat16, False, (0, 512, 0), 8, "vec"),     # zero_dce_re's 1080p
    ((1, 1088, 1920, 3), torch.float32, False, (0, 0, 0), 8, "vec"),
    ((1, 1088, 1920, 3), torch.bfloat16, False, (0, 4, 0), 8, "general"),
    ((1, 1088, 1920, 3), torch.float32, False, (0, 0, 8), 8, "general"),
    ((1, 256, 256, 1), torch.float32, False, (0, 0, 0), 15, "general"),     # zero_dce_v, C = 1
    ((1, 16, 16, 3), torch.float32, False, (0, 0, 0), 16, "general"),       # only 8 on "vec"
    ((1, 16, 16, 3), torch.float32, False, (0, 0, 0), 7, "general"),
    ((1, 16, 16, 3), torch.bfloat16, False, (0, 0, 0), 0, "general"),
])
def test_apply_path_choices(shape, dtype, shared, ptrs, iters, path):
    assert dce_curve.apply_path(shape, dtype, shared, ptrs, iters) == path


def test_apply_on_cpu_counts_no_path():
    before = (dce_curve.fused_curve_apply.launches,
              dict(dce_curve.fused_curve_apply.path_launches))
    x = torch.zeros(1, 8, 8, 3)
    dce_curve.fused_curve_apply(x, torch.zeros(1, 8, 8, 3), shared=True)
    dce_curve.fused_curve_apply(x, torch.zeros(1, 8, 8, 24))
    assert (dce_curve.fused_curve_apply.launches,
            dce_curve.fused_curve_apply.path_launches) == before
