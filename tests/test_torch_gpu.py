"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. The machine with the card
has no JAX, so this file imports none, and tests/conftest.py (which sets up
JAX) is left out there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from enhax_torch.infer import Predictor
from enhax_torch.kernels import dce_curve
from enhax_torch.models.base import build_model

pytestmark = pytest.mark.gpu

TOL_F32 = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # float32 convs run in TF32 by default on the card; compare in full f32
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _rand(shape, lo, hi, dtype, seed=0):
    a = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _check(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if out.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= TOL_F32
    else:  # bfloat16: at most 1 uint8 LSB after x255, round, clip
        u8 = [(t.float() * 255).round().clamp(0, 255) for t in (out, ref)]
        assert (u8[0] - u8[1]).abs().max().item() <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, scale", [((2, 36, 52, 3), 4), ((2, 40, 72, 3), 8)])
def test_upsample_kernel_matches_plain(cuda, dtype, shape, scale):
    n, h, w, c = shape
    x = _rand(shape, 0, 1, dtype)
    r = _rand((n, h // scale, w // scale, c), -1, 1, dtype, seed=1)
    before = dce_curve.fused_curve_upsample_apply.launches
    out = dce_curve.fused_curve_upsample_apply(x, r, num_iters=8, scale=scale)
    assert dce_curve.fused_curve_upsample_apply.launches == before + 1
    _check(out, dce_curve.fused_curve_upsample_apply_plain(x, r, 8, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared, rc", [(False, 24), (True, 3)])
def test_apply_kernel_matches_plain(cuda, dtype, shared, rc):
    x = _rand((2, 37, 53, 3), 0, 1, dtype)
    r = _rand((2, 37, 53, rc), -1, 1, dtype, seed=1)
    before = dce_curve.fused_curve_apply.launches
    out = dce_curve.fused_curve_apply(x, r, num_iters=8, shared=shared)
    assert dce_curve.fused_curve_apply.launches == before + 1
    _check(out, dce_curve.fused_curve_apply_plain(x, r, 8, shared))


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = _rand((1, 8, 8, 3), 0, 1, torch.float32)
    with pytest.raises(ValueError, match="curves on cpu"):
        dce_curve.fused_curve_apply(x, torch.zeros(1, 8, 8, 24))
    with pytest.raises(ValueError, match="contiguous"):
        dce_curve.fused_curve_upsample_apply(x.transpose(1, 2),
                                             _rand((1, 2, 2, 3), -1, 1, torch.float32),
                                             scale=4)


@pytest.mark.parametrize("name, kw", [("zero_dce++_re", {"scale_factor": 8.0}),
                                      ("zero_dce_re", {})])
def test_model_on_card_matches_cpu(cuda, name, kw):
    x = np.random.default_rng(2).uniform(0, 0.3, (2, 64, 96, 3)).astype(np.float32)
    gpu = build_model(name, device="cuda", **kw)
    cpu = build_model(name, device="cpu", **kw)
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})
        oc = cpu.apply({"image": torch.from_numpy(x)})
    for key in ("enhanced", "adjust"):
        assert (og[key].cpu() - oc[key]).abs().max().item() <= 1e-4


def test_predictor_serves_on_card(cuda):
    pred = Predictor(build_model("zero_dce++_re", scale_factor=8.0), bf16=True)
    x = np.random.default_rng(3).uniform(0, 0.3, (601, 803, 3)).astype(np.float32)
    before = dce_curve.fused_curve_upsample_apply.launches
    out = pred.infer({"image": x})["enhanced"]
    assert dce_curve.fused_curve_upsample_apply.launches == before + 1
    assert out.is_cuda and tuple(out.shape) == (1, 601, 803, 3)
    assert torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1
