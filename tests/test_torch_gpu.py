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


# -- the fused NAFBlock kernels ------------------------------------------------

def _block_params(c, dtype, seed=0):
    """A NAFBlock's params on the card, every one shifted from a seed, beta and
    gamma drawn: at their init (zero) the block returns x and nothing after
    the gate would be checked."""
    from enhax_torch.models.multitask.nafnet import NAFBlock
    blk = NAFBlock(c)
    gen = np.random.default_rng(seed)
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            lo, hi = (-0.5, 0.5) if name in ("beta", "gamma") else (0.0, 0.1)
            prm.add_(torch.from_numpy(gen.uniform(lo, hi, prm.shape).astype(np.float32)))
    blk.to("cuda", dtype)
    return dict(blk.named_parameters())


def _check_rel(out, ref):
    """f32: 1e-5, bf16: 2^-6 (two bf16 steps), both times max(1, max|ref|).
    In f32 the first and last rows and columns are no worse than twice the
    interior (in bf16 the error is a rounding flip here and there)."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    tol = (1e-5 if out.dtype == torch.float32 else 2.0 ** -6) * scale
    assert err.max().item() <= tol, (err.max().item(), tol)
    if out.dtype == torch.float32 and out.shape[1] > 2 and out.shape[2] > 2:
        inner = max(err[:, 1:-1, 1:-1].max().item(), tol / 8)
        for edge in (err[:, 0], err[:, -1], err[:, :, 0], err[:, :, -1]):
            assert edge.max().item() <= 2 * inner


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 37, 8), (1, 1, 45, 16), (2, 29, 61, 32),
                                   (1, 15, 31, 64)])
def test_k1_kernel_matches_plain(cuda, dtype, shape):
    from enhax_torch.kernels import nafblock
    p = _block_params(shape[-1], dtype)
    x = _rand(shape, -1, 1, dtype, seed=4)
    before = nafblock.k1_apply.launches
    with torch.inference_mode():
        out = nafblock.k1_apply(x, p)
        ref = nafblock.k1_plain(x, p)
    assert nafblock.k1_apply.launches == before + 1
    _check_rel(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("shape", [(2, 17, 37, 8), (1, 1, 45, 16), (2, 29, 61, 32),
                                   (1, 15, 31, 64)])
def test_k2_kernel_matches_plain(cuda, dtype, spatial, shape):
    from enhax_torch.kernels import nafblock
    b, _, _, c = shape
    p = _block_params(c, dtype)
    x = _rand(shape, -1, 1, dtype, seed=5)
    g = _rand(shape, -1, 1, dtype, seed=6)
    pooled = _rand(shape if spatial else (b, 1, 1, c), -1, 1, dtype, seed=7)
    before = nafblock.k2_apply.launches
    with torch.inference_mode():
        out = nafblock.k2_apply(x, g, pooled, p)
        ref = nafblock.k2_plain(x, g, pooled, p)
    assert nafblock.k2_apply.launches == before + 1
    _check_rel(out, ref)


def test_kernel_wrappers_refuse_autograd(cuda):
    from enhax_torch.kernels import nafblock
    x = _rand((1, 8, 8, 3), 0, 1, torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        dce_curve.fused_curve_apply(x, _rand((1, 8, 8, 24), -1, 1, torch.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        dce_curve.fused_curve_upsample_apply(x, _rand((1, 2, 2, 3), -1, 1, torch.float32),
                                             scale=4)
    p = _block_params(8, torch.float32)   # nn.Parameters: they require grad
    y = _rand((1, 8, 8, 8), -1, 1, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        nafblock.k1_apply(y, p)
    with pytest.raises(RuntimeError, match="no backward"):
        nafblock.k2_apply(y, y, y, p)
    with torch.no_grad():
        assert nafblock.k1_apply(y, p).grad_fn is None


@pytest.mark.parametrize("name", ["nafnet_local", "nafnet"])
def test_nafnet_on_card_matches_cpu(cuda, name):
    from enhax_torch.kernels import nafblock
    cpu = build_model(name, device="cpu", seed=1)
    gen = np.random.default_rng(1)
    with torch.no_grad():
        for pname, prm in cpu.module.named_parameters():
            lo, hi = (-0.2, 0.2) if pname.endswith(("beta", "gamma")) else (0.0, 0.02)
            prm.add_(torch.from_numpy(gen.uniform(lo, hi, prm.shape).astype(np.float32)))
    gpu = build_model(name, device="cpu", seed=1)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    x = gen.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    before = (nafblock.k1_apply.launches, nafblock.k2_apply.launches)
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})["enhanced"].cpu()
        oc = cpu.apply({"image": torch.from_numpy(x)})["enhanced"]
    assert (nafblock.k1_apply.launches, nafblock.k2_apply.launches) == (
        before[0] + 8, before[1] + 8)
    scale = max(1.0, oc.abs().max().item())
    assert (og - oc).abs().max().item() <= 1e-4 * scale


def test_predictor_serves_nafnet_on_card(cuda):
    from enhax_torch.kernels import nafblock
    pred = Predictor(build_model("nafnet_local"), bf16=True)
    x = np.random.default_rng(3).uniform(0, 1, (61, 83, 3)).astype(np.float32)
    before = nafblock.k1_apply.launches
    out = pred.infer({"image": x})["enhanced"]
    assert nafblock.k1_apply.launches == before + 8
    assert out.is_cuda and tuple(out.shape) == (1, 61, 83, 3)
    assert torch.isfinite(out).all()
