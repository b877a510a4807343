"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. The machine with the card
has no JAX, so this file imports none, and tests/conftest.py (which sets up
JAX) is left out there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from enhax_torch.infer import Predictor
from enhax_torch.kernels import dce_curve
from enhax_torch.models.base import build_model
from torch_threads import capped_torch_threads  # noqa: F401

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


# (N, H, W, C), scale: H of one band of 16 rows (one low-resolution row at
# s=8 with W of one 8-pixel group), of several bands with a short last one,
# N x H past 65,535 rows
UPSAMPLE_VEC = [((1, 8, 8, 3), 8), ((2, 16, 64, 3), 2), ((3, 36, 48, 3), 4),
                ((2, 40, 72, 3), 8), ((2, 64, 128, 3), 4), ((3, 22000, 8, 3), 8),
                ((2, 1088, 1920, 3), 8)]
UPSAMPLE_GENERAL = [((2, 36, 52, 3), 4), ((2, 40, 72, 4), 8), ((1, 18, 24, 3), 3),
                    ((2, 24, 20, 1), 2)]


def _upsample_on(path, shape, scale, dtype, x=None):
    n, h, w, c = shape
    x = _rand(shape, 0, 1, dtype, seed=4) if x is None else x
    r = _rand((n, h // scale, w // scale, c), -1, 1, dtype, seed=5)
    assert dce_curve.upsample_path(x.shape, dtype, scale, x.data_ptr()) == path
    before = dict(dce_curve.fused_curve_upsample_apply.path_launches)
    out = dce_curve.fused_curve_upsample_apply(x, r, num_iters=8, scale=scale)
    after = dce_curve.fused_curve_upsample_apply.path_launches
    assert {k: after[k] - before[k] for k in after} == {
        p: int(p == path) for p in dce_curve.UPSAMPLE_PATHS}
    _check(out, dce_curve.fused_curve_upsample_apply_plain(x, r, 8, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, scale", UPSAMPLE_VEC)
def test_upsample_vec_path_matches_plain(cuda, dtype, shape, scale):
    _upsample_on("vec", shape, scale, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, scale", UPSAMPLE_GENERAL)
def test_upsample_general_path_matches_plain(cuda, dtype, shape, scale):
    _upsample_on("general", shape, scale, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_takes_the_general_path_on_a_misaligned_base(cuda, dtype):
    shape = (2, 32, 64, 3)
    x = torch.empty(int(np.prod(shape)) + 2, device="cuda", dtype=dtype)[2:].view(shape)
    x.copy_(_rand(shape, 0, 1, dtype, seed=6))
    _upsample_on("general", shape, 8, dtype, x)


def test_upsample_paths_agree(cuda):
    """Both paths on the vec path's inputs: the same arithmetic, so within
    the kernels' bound of each other too."""
    x = _rand((2, 64, 128, 3), 0, 1, torch.float32, seed=7)
    r = _rand((2, 8, 16, 3), -1, 1, torch.float32, seed=8)
    vec = dce_curve._upsample_launch(x, r, 8, 8, "vec")
    _check(vec, dce_curve._upsample_launch(x, r, 8, 8, "general"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared, rc", [(False, 24), (True, 3)])
def test_apply_kernel_matches_plain(cuda, dtype, shared, rc):
    x = _rand((2, 37, 53, 3), 0, 1, dtype)
    r = _rand((2, 37, 53, rc), -1, 1, dtype, seed=1)
    before = dce_curve.fused_curve_apply.launches
    out = dce_curve.fused_curve_apply(x, r, num_iters=8, shared=shared)
    assert dce_curve.fused_curve_apply.launches == before + 1
    _check(out, dce_curve.fused_curve_apply_plain(x, r, 8, shared))


# (N, H, W, C), shared, iterations on the apply kernel's "vec" path: a
# shared curve at 273 values (not a multiple of 8), one pixel, C = 4 and
# SGZ's batch; per-iteration curves at C = 3 with 8 iterations at one
# pixel, 15 and 3922 pixels (the last warp's item short) and Zero-DCE's
# 1080p request
APPLY_VEC = [((1, 7, 13, 3), True, 8), ((1, 1, 1, 3), True, 8), ((3, 33, 65, 4), True, 8),
             ((4, 1092, 1920, 3), True, 8), ((1, 1, 1, 3), False, 8), ((1, 3, 5, 3), False, 8),
             ((2, 37, 53, 3), False, 8), ((1, 1088, 1920, 3), False, 8)]


def _apply_on(path, shape, shared, iters, dtype, x=None, r=None):
    """fused_curve_apply through the wrapper: ``apply_path`` names ``path``,
    the wrapper counts one launch on it and none on the other, and the
    output is within the DCE tolerances of the plain version."""
    rc = shape[-1] * (1 if shared else iters)
    x = _rand(shape, 0, 0.3, dtype, seed=9) if x is None else x
    r = _rand(shape[:3] + (rc,), -1, 1, dtype, seed=10) if r is None else r
    assert dce_curve.apply_path(shape, dtype, shared, (x.data_ptr(), r.data_ptr(), 0),
                                iters) == path
    before = dict(dce_curve.fused_curve_apply.path_launches)
    out = dce_curve.fused_curve_apply(x, r, num_iters=iters, shared=shared)
    after = dce_curve.fused_curve_apply.path_launches
    assert {k: after[k] - before[k] for k in after} == {
        p: int(p == path) for p in dce_curve.APPLY_PATHS}
    _check(out, dce_curve.fused_curve_apply_plain(x, r, iters, shared))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, shared, iters", APPLY_VEC)
def test_apply_vec_path_matches_plain(cuda, dtype, shape, shared, iters):
    _apply_on("vec", shape, shared, iters, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_general_path_at_the_instance_form(cuda, dtype):
    _apply_on("general", (2, 64, 64, 1), False, 15, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, iters", [((2, 17, 31, 3), 7), ((1, 40, 40, 3), 16)])
def test_apply_general_path_at_other_iteration_counts(cuda, dtype, shape, iters):
    _apply_on("general", shape, False, iters, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("moved", ["image", "curves"])
def test_apply_takes_the_general_path_on_a_misaligned_base(cuda, dtype, shared, moved):
    shape = (2, 32, 64, 3)
    t = _rand(shape[:3] + (3 if shared or moved == "image" else 24,), 0, 0.3, dtype, seed=11)
    off = torch.empty(t.numel() + 2, device="cuda", dtype=dtype)[2:].view(t.shape)
    off.copy_(t)
    if moved == "image":
        _apply_on("general", shape, shared, 8, dtype, x=off)
    else:
        _apply_on("general", shape, shared, 8, dtype, r=off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, shared, iters", [((2, 37, 53, 3), True, 8),
                                                  ((2, 37, 53, 3), False, 8),
                                                  ((1, 40, 40, 3), False, 8)])
def test_apply_paths_agree(cuda, dtype, shape, shared, iters):
    """Both paths on the vec path's inputs: the same arithmetic (two fused
    multiply-adds an iteration), so within the kernels' bound of each other."""
    x = _rand(shape, 0, 1, dtype, seed=12)
    r = _rand(shape[:3] + (shape[-1] * (1 if shared else iters),), -1, 1, dtype, seed=13)
    vec = dce_curve._apply_launch(x, r, iters, shared, "vec")
    _check(vec, dce_curve._apply_launch(x, r, iters, shared, "general"))


@pytest.mark.parametrize("case", ["16 iterations", "C = 1", "misaligned image"])
def test_apply_vec_path_refuses_what_it_does_not_take(cuda, case):
    """The C entry refuses "vec" where its conditions fail (cudaErrorInvalidValue,
    1), so a wrong choice raises instead of computing something else."""
    shape, iters = {"16 iterations": ((1, 8, 8, 3), 16), "C = 1": ((1, 8, 8, 1), 15),
                    "misaligned image": ((1, 8, 8, 3), 8)}[case]
    x = _rand(shape, 0, 1, torch.float32)
    if case == "misaligned image":
        x = torch.empty(x.numel() + 2, device="cuda")[2:].view(shape).copy_(x)
    r = _rand(shape[:3] + (shape[-1] * iters,), -1, 1, torch.float32, seed=1)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        dce_curve._apply_launch(x, r, iters, False, "vec")


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


# the bf16 forms' geometry: W against K1's strips (62 columns at C <= 32, 30
# at C = 64) and K2's 16-pixel tiles, H against K1's runs of 64 rows (67:
# two runs), B = 3
NAF_WIDTHS = [8, 16, 32, 64]
NAF_RAGGED_W = (1, 7, 33, 65, 129)


@pytest.mark.parametrize("h", [1, 2, 3, 17, 67])
@pytest.mark.parametrize("c", NAF_WIDTHS)
def test_k1_bf16_form_matches_plain(cuda, c, h):
    from enhax_torch.kernels import nafblock
    assert nafblock.design(c, torch.bfloat16)["k1"] == "bf16"
    p = _block_params(c, torch.bfloat16, seed=c)
    for w in NAF_RAGGED_W:
        x = _rand((3, h, w, c), -1, 1, torch.bfloat16, seed=w)
        before = nafblock.k1_apply.launches
        with torch.inference_mode():
            out = nafblock.k1_apply(x, p)
            ref = nafblock.k1_plain(x, p)
        assert nafblock.k1_apply.launches == before + 1
        _check_rel(out, ref)


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("h", [1, 2, 3, 17, 67])
@pytest.mark.parametrize("c", NAF_WIDTHS)
def test_k2_bf16_form_matches_plain(cuda, c, h, spatial):
    from enhax_torch.kernels import nafblock
    assert nafblock.design(c, torch.bfloat16)["k2"] == "bf16"
    p = _block_params(c, torch.bfloat16, seed=c)
    for w in NAF_RAGGED_W:
        shape = (3, h, w, c)
        x, g = (_rand(shape, -1, 1, torch.bfloat16, seed=w + k) for k in (0, 1))
        pooled = _rand(shape if spatial else (3, 1, 1, c), -1, 1, torch.bfloat16, seed=w + 2)
        before = nafblock.k2_apply.launches
        with torch.inference_mode():
            out = nafblock.k2_apply(x, g, pooled, p)
            ref = nafblock.k2_plain(x, g, pooled, p)
        assert nafblock.k2_apply.launches == before + 1
        _check_rel(out, ref)


@pytest.mark.parametrize("c", NAF_WIDTHS)
def test_nafblock_forms_by_dtype(cuda, c):
    """bfloat16 takes the bf16 forms at every width; float32 keeps the
    general forms."""
    from enhax_torch.kernels import nafblock
    assert nafblock.design(c, torch.bfloat16) == {"k1": "bf16", "k2": "bf16"}
    assert nafblock.design(c, torch.float32) == {"k1": "general", "k2": "general"}


def test_nafblock_bf16_forms_refuse_a_misaligned_base(cuda):
    from enhax_torch.kernels import nafblock
    p = _block_params(32, torch.bfloat16)
    shape = (1, 4, 5, 32)
    x = _rand(shape, -1, 1, torch.bfloat16)
    off = torch.empty(x.numel() + 4, device="cuda", dtype=torch.bfloat16)[4:].view(shape)
    off.copy_(x)   # 8 bytes into its buffer
    with torch.inference_mode():
        with pytest.raises(ValueError, match="16-byte aligned"):
            nafblock.k1_apply(off, p)
        with pytest.raises(ValueError, match="16-byte aligned"):
            nafblock.k2_apply(x, off, x, p)
        assert nafblock.k1_apply(x, p).shape == shape   # the aligned base runs


def test_k2_bf16_form_is_the_same_from_run_to_run(cuda):
    from enhax_torch.kernels import nafblock
    p = _block_params(64, torch.bfloat16)
    shape = (2, 93, 157, 64)
    x, g, pooled = (_rand(shape, -1, 1, torch.bfloat16, seed=k) for k in (20, 21, 22))
    with torch.inference_mode():
        a = nafblock.k2_apply(x, g, pooled, p)
        b = nafblock.k2_apply(x, g, pooled, p)
        c = nafblock.k1_apply(x, p)
        d = nafblock.k1_apply(x, p)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_nafblock_weights_are_prepared_anew_after_an_update_and_a_cast(cuda):
    """The bf16 forms' prepared layouts follow an in-place update of a param
    (the kernel's output follows it too) and a cast of the block."""
    from enhax_torch.kernels import nafblock
    from enhax_torch.models.multitask.nafnet import NAFBlock
    blk = NAFBlock(32)
    blk.to("cuda", torch.bfloat16)
    p = dict(blk.named_parameters())
    x = _rand((1, 9, 40, 32), -1, 1, torch.bfloat16)
    g = _rand(x.shape, -1, 1, torch.bfloat16, seed=1)
    pooled = g.mean(dim=(1, 2), keepdim=True)
    first = nafblock.k1_weights(p)
    assert all(a is b for a, b in zip(first, nafblock.k1_weights(p)))   # kept
    with torch.no_grad():
        p["norm1.bias"].add_(0.25)
        p["gamma"].fill_(0.5)
    second = nafblock.k1_weights(p)
    assert second[1] is not first[1]
    assert torch.equal(second[1][32:64], p["norm1.bias"].detach().float())
    assert torch.equal(nafblock.k2_weights(p)[4][256:], torch.full((32,), 0.5, device="cuda"))
    with torch.inference_mode():
        _check_rel(nafblock.k1_apply(x, p), nafblock.k1_plain(x, p))
        _check_rel(nafblock.k2_apply(x, g, pooled, p), nafblock.k2_plain(x, g, pooled, p))
    blk.float()
    p = dict(blk.named_parameters())
    w1, vec = nafblock.k1_weights(p)
    assert w1.dtype == torch.float32 and w1.data_ptr() == p["conv1.weight"].data_ptr()


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


# -- the fused RestormerBlock kernels --------------------------------------------

# the published levels, then the small Restormer's (dim 8, heads (1, 1, 2, 2))
RESTORMER_PUBLISHED = [(48, 1), (96, 1), (96, 2), (192, 4), (384, 8)]
RESTORMER_NARROW = [(8, 1), (16, 1), (32, 2), (64, 2)]
RESTORMER_WIDTHS = RESTORMER_PUBLISHED + RESTORMER_NARROW


def _restormer_params(c, heads, dtype, seed=0):
    """A RestormerBlock's params on the card: temperature drawn in [0.5, 3],
    LayerNorms shifted, every kernel drawn with variance 1/fan_in."""
    from enhax_torch.models.multitask.restormer import RestormerBlock
    blk = RestormerBlock(c, heads)
    gen = np.random.default_rng(seed)
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            if name.endswith("temperature"):
                a = gen.uniform(0.5, 3.0, prm.shape)
            elif ".body." in name:
                a = prm.numpy() + gen.uniform(-0.2, 0.2, prm.shape)
            else:
                a = gen.normal(0, 1 / np.sqrt(prm[0].numel()), prm.shape)
            prm.copy_(torch.from_numpy(a.astype(np.float32)))
    blk.to("cuda", dtype)
    return dict(blk.named_parameters())


def _check_sums(out, ref, dtype):
    """R1's float32 sums: 1e-5 * max|ref| for float32 x (sums over all pixels
    in another order); 1e-3 * max|ref| for bfloat16 x, whose LN output is
    rounded to bf16 before the 1x1: an LN one float32 step apart may round
    the other way and move q and k."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.float32
    err = (out - ref).abs().max().item()
    rel = 1e-5 if dtype == torch.float32 else 1e-3
    assert err <= rel * ref.abs().max().item(), (err, ref.abs().max().item())


# ragged against both tiles (8x8 and 8x16): H and W not multiples of 8 or 16,
# several tiles an image, one-row images
RESTORMER_RAGGED = [(2, 19, 29), (1, 1, 37), (1, 37, 53)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
@pytest.mark.parametrize("shape", RESTORMER_RAGGED)
def test_r1_kernel_matches_plain(cuda, dtype, c, heads, shape):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(c, heads, dtype)
    x = _rand(shape + (c,), -1, 1, dtype, seed=8)
    before = rb.r1_apply.launches
    with torch.inference_mode():
        out = rb.r1_apply(x, p)
        ref = rb.r1_plain(x, p)
    assert rb.r1_apply.launches == before + 1
    _check_rel(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:]):
        _check_sums(o, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
@pytest.mark.parametrize("shape", RESTORMER_RAGGED)
def test_r2_kernel_matches_plain(cuda, dtype, c, heads, shape):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(c, heads, dtype)
    x = _rand(shape + (c,), -1, 1, dtype, seed=9)
    v = _rand(shape + (c,), -1, 1, dtype, seed=10)
    logits = _rand((shape[0], c, c // heads), -3, 3, torch.float32, seed=11)
    attn = logits.softmax(-1).to(dtype)
    before = rb.r2_apply.launches
    with torch.inference_mode():
        out = rb.r2_apply(x, v, attn, p)
        ref = rb.r2_plain(x, v, attn, p)
    assert rb.r2_apply.launches == before + 1
    _check_rel(out, ref)


@pytest.mark.parametrize("c, dtype", [(48, torch.float32), (96, torch.bfloat16)])
def test_r1_is_the_same_from_run_to_run(cuda, c, dtype):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(c, 1, dtype)
    x = _rand((2, 200, 120, c), -1, 1, dtype, seed=12)
    with torch.inference_mode():
        a, b = rb.r1_apply(x, p), rb.r1_apply(x, p)
    for s, t in zip(a, b):
        assert torch.equal(s, t)


# each level's chunk shape on the tiled path (8 tiles of 384x384) and heads
RESTORMER_LEVELS = [((8, 384, 384, 48), 1), ((8, 384, 384, 96), 1), ((8, 192, 192, 96), 2),
                    ((8, 96, 96, 192), 4), ((8, 48, 48, 384), 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, heads", RESTORMER_LEVELS)
def test_r1_grid_is_one_wave_on_the_card(cuda, dtype, shape, heads):
    from enhax_torch.kernels import restormer_block as rb
    b, h, w, c = shape
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    for mxu in (False, True):
        resident, tile = rb.r1_geometry(code, c, heads, mxu)
        splits = rb.r1_grid(resident, b, heads, rb.r1_tiles(h, w, tile))
        assert splits * b * heads <= resident
        assert resident >= torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
def test_forms_by_width(cuda, c, heads, mxu):
    """bf16 takes the bf16 forms at every published width (R1-mxu and
    R2-mxu too) and the general forms at the narrow ones; float32 keeps the
    general forms."""
    from enhax_torch.kernels import restormer_block as rb
    form = "bf16" if (c, heads) in RESTORMER_PUBLISHED else "general"
    assert rb.design(1, c, heads, mxu=mxu) == {"r1": form, "r2": form}
    assert rb.design(0, c, heads, mxu=mxu) == {"r1": "general", "r2": "general"}


# the golden chain's shapes (4 images of 64x64): C = 8 at 64x64 and C = 16
# at 32x32 and 64x64 (the refinement) in restormer_tiny; C = 32 and 64 at
# the shape too, which a larger image reaches
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, heads", RESTORMER_NARROW)
@pytest.mark.parametrize("hw", [(64, 64), (32, 32)])
def test_narrow_widths_match_plain_at_the_golden_shape(cuda, dtype, c, heads, hw):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(c, heads, dtype, seed=c)
    x = _rand((4,) + hw + (c,), -1, 1, dtype, seed=13)
    with torch.inference_mode():
        v, gram, qss, kss = rb.r1_apply(x, p)
        ref = rb.r1_plain(x, p)
        _check_rel(v, ref[0])
        for o, r in zip((gram, qss, kss), ref[1:]):
            _check_sums(o, r, dtype)
        attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], dtype)
        _check_rel(rb.r2_apply(x, v, attn, p), rb.r2_plain(x, v, attn, p))


@pytest.mark.parametrize("bf16", [False, True])
def test_restormer_tiny_serves_through_the_kernels(cuda, bf16):
    """run/make_quality.py's restormer_tiny through Predictor on the card:
    every block at min(H, W) >= 32 through R1/R2 (enc0, dec0 and the
    refinement at 64x64, enc1 and dec1 at 32x32: 5), the output within
    1e-4 x max(1, max|ref|) of the CPU's float32 (bf16: 3e-2, the bound
    HINet's bf16 serving is held to against float32)."""
    from enhax_torch.kernels import restormer_block as rb
    cfg = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "heads": (1, 1, 2, 2)}
    cpu = build_model("restormer", device="cpu", seed=3, **cfg)
    card = build_model("restormer", device="cuda", seed=3, **cfg)
    card.module.load_state_dict(cpu.module.state_dict())
    img = np.random.default_rng(14).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    r1, r2 = rb.r1_apply.launches, rb.r2_apply.launches
    out = Predictor(card, device="cuda", bf16=bf16)({"image": img})["enhanced"].float().cpu()
    assert rb.r1_apply.launches - r1 == rb.r2_apply.launches - r2 == 5
    ref = Predictor(cpu, device="cpu")({"image": img})["enhanced"].float()
    err = (out - ref).abs().max().item()
    print(f"restormer_tiny bf16={bf16}: max|d| {err:.4e}, max|ref| {ref.abs().max().item():.4e}")
    assert err <= (3e-2 if bf16 else 1e-4) * max(1.0, ref.abs().max().item()), err


def _lost_partial_sum(r1):
    """R1 with half of its gram lost, as a split reduction that drops one
    of two partial sums would (its launch count kept)."""
    @functools.wraps(r1)
    def fault(x, p):
        v, gram, qss, kss = r1(x, p)
        return v, gram * 0.5, qss, kss
    return fault


def _skipped_last_row(r2):
    """R2 that leaves the last pixel row as its input, as a ragged tail
    tile left unprocessed would (its launch count kept)."""
    @functools.wraps(r2)
    def fault(x, v, attn, p):
        out = r2(x, v, attn, p).clone()
        out[:, -1] = x[:, -1]
        return out
    return fault


@pytest.mark.parametrize("fault", ["lost_partial_sum", "skipped_last_row"])
def test_restormer_tiny_bf16_bound_catches_a_wrong_kernel(cuda, monkeypatch, fault):
    """The 3e-2 x max(1, max|ref|) bound of the bf16 case above fails a
    planted kernel fault: restormer_tiny's bf16 serving with R1 or R2
    wrapped so as to compute a wrong block reads above it."""
    from enhax_torch.kernels import restormer_block as rb
    cfg = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "heads": (1, 1, 2, 2)}
    cpu = build_model("restormer", device="cpu", seed=3, **cfg)
    card = build_model("restormer", device="cuda", seed=3, **cfg)
    card.module.load_state_dict(cpu.module.state_dict())
    img = np.random.default_rng(14).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    if fault == "lost_partial_sum":
        monkeypatch.setattr(rb, "r1_apply", _lost_partial_sum(rb.r1_apply))
    else:
        monkeypatch.setattr(rb, "r2_apply", _skipped_last_row(rb.r2_apply))
    out = Predictor(card, device="cuda", bf16=True)({"image": img})["enhanced"].float().cpu()
    ref = Predictor(cpu, device="cpu")({"image": img})["enhanced"].float()
    err = (out - ref).abs().max().item()
    bound = 3e-2 * max(1.0, ref.abs().max().item())
    print(f"restormer_tiny bf16 with {fault}: max|d| {err:.4e}, bound {bound:.4e}")
    assert err > bound, (err, bound)


def test_restormer_wrappers_refuse(cuda):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(32, 1, torch.float32)
    x = _rand((1, 8, 8, 32), -1, 1, torch.float32)
    with torch.inference_mode(), pytest.raises(ValueError, match="built for"):
        rb.r1_apply(x, p)
    p = _restormer_params(48, 1, torch.float32)   # nn.Parameters: they require grad
    y = _rand((1, 8, 8, 48), -1, 1, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        rb.r1_apply(y, p)
    with pytest.raises(RuntimeError, match="no backward"):
        rb.r2_apply(y, y, torch.zeros(1, 48, 48, device="cuda"), p)


def test_restormer_on_card_matches_cpu(cuda):
    """Full width at 64x64: levels 0-1 fused (64, 32), levels 2-3 (16, 8)
    the module's block."""
    from enhax_torch.kernels import restormer_block as rb
    cpu = build_model("restormer", device="cpu", seed=2)
    gen = np.random.default_rng(2)
    with torch.no_grad():
        for name, prm in cpu.module.named_parameters():
            if name.endswith("temperature"):
                prm.copy_(torch.from_numpy(gen.uniform(0.5, 3.0, prm.shape).astype(np.float32)))
            elif ".body." in name:
                prm.add_(torch.from_numpy(gen.uniform(-0.2, 0.2, prm.shape).astype(np.float32)))
    gpu = build_model("restormer", device="cpu", seed=2)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    x = gen.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    before = rb.r1_apply.launches
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})["enhanced"].cpu()
        oc = cpu.apply({"image": torch.from_numpy(x)})["enhanced"]
    # enc0, dec0, refinement at 64x64 (4 each), enc1, dec1 at 32x32 (6 each)
    assert rb.r1_apply.launches == before + 24
    scale = max(1.0, oc.abs().max().item())
    assert (og - oc).abs().max().item() <= 1e-4 * scale


def test_tiled_predictor_serves_restormer_on_card(cuda):
    from enhax_torch.kernels import restormer_block as rb
    pred = Predictor(build_model("restormer"), tile=(96, 96, 16), bf16=True)
    x = np.random.default_rng(4).uniform(0, 1, (150, 170, 3)).astype(np.float32)
    before = rb.r2_apply.launches
    out = pred.infer({"image": x})["enhanced"]
    # 152x176 in tiles of 96 with stride 80: 2 x 2 tiles, one chunk of 6;
    # levels at 96, 48 fused (4 + 6 + 6 + 4 + 4 blocks), 24 and 12 not
    assert rb.r2_apply.launches == before + 24
    assert out.is_cuda and tuple(out.shape) == (1, 150, 170, 3)
    assert torch.isfinite(out).all()


# -- the tap-folded RestormerBlock kernels and the probe kernels ------------------

# the last four ragged against the bf16 forms' tiles (8x16; 8x8 for R1 at
# C = 384): H not a multiple of 8, W not a multiple of 16, W < 16, one row
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
@pytest.mark.parametrize("shape", [(2, 19, 29), (1, 1, 37), (1, 13, 21), (2, 9, 7), (1, 1, 5),
                                   (2, 17, 40)])
def test_mxu_kernels_match_plain(cuda, dtype, c, heads, shape):
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(c, heads, dtype)
    x = _rand(shape + (c,), -1, 1, dtype, seed=13)
    before = (rb.r1_mxu_apply.launches, rb.r2_mxu_apply.launches)
    with torch.inference_mode():
        out = rb.r1_mxu_apply(x, p)
        ref = rb.r1_mxu_plain(x, p)
        attn = rb.mdta_attention(*ref[1:], p["attn.temperature"], dtype)
        out2 = rb.r2_mxu_apply(x, ref[0], attn, p)
        ref2 = rb.r2_mxu_plain(x, ref[0], attn, p)
    assert (rb.r1_mxu_apply.launches, rb.r2_mxu_apply.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    _check_rel(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:]):
        _check_sums(o, r, dtype)
    _check_rel(out2, ref2)


def test_r1_mxu_bf16_gram_at_one_row_over_draws(cuda):
    """R1-mxu's bf16 gram at a one-row image, (1, 1, 37, 384) with 8 heads,
    over 200 draws made as chip_smoke.py makes them: torch seeded with the
    draw's number builds the block, a numpy generator of the same number
    draws its temperature, LayerNorm shifts and x. The LayerNorm is rounded
    to bf16 before a sum over 9C terms and q and k after it, so float32
    arithmetic in another order moves some of them by one bf16 step, and
    over 37 pixels the plain version goes over chip_smoke.py's bound (1e-3 x
    max|ref|) against the same block in float64 on some draws. The witness is that float64 block
    (``r1_mxu_witness_gram``: the LayerNorm and the folded product in
    float64), and the kernel is held to the plain version's own accuracy
    against it: over the bound on no more draws than the plain version, by
    no larger a factor."""
    from enhax_torch.kernels import restormer_block as rb
    from enhax_torch.models.multitask.restormer import RestormerBlock
    over = {"kernel": [], "plain": []}
    for seed in range(200):
        torch.manual_seed(seed)
        gen = np.random.default_rng(seed)
        blk = RestormerBlock(384, 8)
        with torch.no_grad():
            for name, prm in blk.named_parameters():
                if name.endswith("temperature"):
                    prm.copy_(torch.from_numpy(gen.uniform(0.5, 3.0, prm.shape).astype(np.float32)))
                elif ".body." in name:
                    prm.add_(torch.from_numpy(gen.uniform(-0.2, 0.2, prm.shape).astype(np.float32)))
        p = dict(blk.to("cuda", torch.bfloat16).named_parameters())
        x = torch.from_numpy(gen.uniform(-1, 1, (1, 1, 37, 384)).astype(np.float32))
        x = x.to("cuda", torch.bfloat16)
        with torch.inference_mode():
            ref = rb.r1_mxu_witness_gram(x, p)
            grams = {"kernel": rb.r1_mxu_apply(x, p)[1], "plain": rb.r1_mxu_plain(x, p)[1]}
        for name, gram in grams.items():
            r = (gram - ref).abs().max().item() / (1e-3 * ref.abs().max().item())
            if r > 1:
                over[name].append((seed, r))
    worst = {name: max([1.0] + [r for _, r in found]) for name, found in over.items()}
    assert len(over["kernel"]) <= len(over["plain"]) and worst["kernel"] <= worst["plain"], (
        f"draws over the bound against the float64 witness (seed, max|d| / bound): {over}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(2, 19, 29, 37), (1, 1, 37, 8), (2, 40, 33, 288)])
def test_dw3x3_kernel_matches_plain(cuda, dtype, rows, shape):
    from enhax_torch.kernels import dw3x3
    x = _rand(shape, -1, 1, dtype, seed=14)
    k = _rand((3, 3, shape[-1]), -1, 1, dtype, seed=15)
    before = dw3x3.dw3x3_apply.launches
    out = dw3x3.dw3x3_apply(x, k, rows)
    assert dw3x3.dw3x3_apply.launches == before + 1
    _check_rel(out, dw3x3.dw3x3_plain(x, k, rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(3, 7, 33, 40), (1, 2, 257, 288), (3, 1, 33, 520),
                                   (1, 9, 257, 40), (3, 2, 65, 288)])
def test_dw3x3_ring_matches_plain(cuda, dtype, rows, shape):
    """The TMA ring: C not a multiple of the channel chunk (40, 520; 288 is
    9 chunks of 64 bytes in bf16, 9 of 128 in float32), W not a multiple of
    the column tile (33, 65, 257), H = 1 and 2, B = 3."""
    from enhax_torch.kernels import dw3x3
    x = _rand(shape, -1, 1, dtype, seed=17)
    k = _rand((3, 3, shape[-1]), -1, 1, dtype, seed=18)
    assert dw3x3.dw3x3_path(x.shape, dtype, x.data_ptr()) == "ring"
    before = dict(dw3x3.dw3x3_apply.path_launches)
    out = dw3x3.dw3x3_apply(x, k, rows)
    assert dw3x3.dw3x3_apply.path_launches == {**before, "ring": before["ring"] + 1}
    _check_rel(out, dw3x3.dw3x3_plain(x, k, rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["zero", "edge"])
@pytest.mark.parametrize("shape", [(3, 7, 33, 40), (1, 2, 257, 288), (2, 1, 33, 520)])
def test_dw3x3_walk_takes_a_misaligned_base(cuda, dtype, rows, shape):
    """x 2 elements into a 16-byte-aligned buffer: the column walk, a
    channel a thread."""
    from enhax_torch.kernels import dw3x3
    n = int(np.prod(shape))
    x = torch.empty(n + 2, device="cuda", dtype=dtype)[2:].view(shape)
    x.copy_(_rand(shape, -1, 1, dtype, seed=19))
    k = _rand((3, 3, shape[-1]), -1, 1, dtype, seed=20)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    before = dict(dw3x3.dw3x3_apply.path_launches)
    out = dw3x3.dw3x3_apply(x, k, rows)
    assert dw3x3.dw3x3_apply.path_launches == {**before, "walk1": before["walk1"] + 1}
    _check_rel(out, dw3x3.dw3x3_plain(x, k, rows))


@pytest.mark.parametrize("erf", ["as", "rational"])
@pytest.mark.parametrize("n", [1, 3, 1001, 4 * 1000 + 3, 4096 * 33, 4 * 1024 * 7 + 4 * 37 + 2])
def test_gelu_kernel_matches_plain(cuda, erf, n):
    from enhax_torch.kernels import gelu
    x = _rand((n,), -6, 6, torch.float32, seed=16)
    before = gelu.gelu_apply.launches
    out = gelu.gelu_apply(x, erf)
    assert gelu.gelu_apply.launches == before + 1
    torch.cuda.synchronize()
    assert (out - gelu.gelu_plain(x, erf)).abs().max().item() <= 1e-6
    # a view 4 bytes into the buffer is not 16-byte aligned: the scalar loop
    out = gelu.gelu_apply(x[1:], erf)
    torch.cuda.synchronize()
    assert out.numel() == 0 or (out - gelu.gelu_plain(x[1:], erf)).abs().max().item() <= 1e-6


def test_new_kernel_wrappers_refuse(cuda):
    from enhax_torch.kernels import dw3x3, gelu
    from enhax_torch.kernels import restormer_block as rb
    p = _restormer_params(48, 1, torch.float32)   # nn.Parameters: they require grad
    y = _rand((1, 8, 8, 48), -1, 1, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        rb.r1_mxu_apply(y, p)
    with pytest.raises(RuntimeError, match="no backward"):
        rb.r2_mxu_apply(y, y, torch.zeros(1, 48, 48, device="cuda"), p)
    x = _rand((1, 8, 8, 16), -1, 1, torch.float32).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        dw3x3.dw3x3_apply(x, _rand((3, 3, 16), -1, 1, torch.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        gelu.gelu_apply(x)
    with pytest.raises(TypeError, match="float32"):
        gelu.gelu_apply(x.detach().bfloat16())
    with torch.inference_mode(), pytest.raises(ValueError, match="built for"):
        rb.r1_mxu_apply(_rand((1, 8, 8, 32), -1, 1, torch.float32),
                        _restormer_params(32, 1, torch.float32))


def test_restormer_dw_mxu_on_card_matches_default(cuda):
    """Every fused block in its tap-folded form against the default fused
    path on the card, full width at 64x64, float32."""
    from enhax_torch.kernels import restormer_block as rb
    model = build_model("restormer", device="cuda", seed=3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3))
                         .astype(np.float32)).cuda()

    def block(y, blk):
        if min(y.shape[1], y.shape[2]) >= 32:
            return rb.restormer_block_fast(y.contiguous(), dict(blk.named_parameters()),
                                           dw_mxu=True)
        return blk(y)

    before = rb.r1_mxu_apply.launches
    with torch.inference_mode():
        ref = rb.restormer_fast_apply(model.module, x)["enhanced"]
        out = model.module(x, block=block)["enhanced"]
    assert rb.r1_mxu_apply.launches == before + 24
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-4 * scale


# -- training through nafblock_fused ----------------------------------------------

# Fused against unfused at NAFNet-SIDD's full width and depth, float32, TF32
# off: the loss and every parameter's gradient within 1e-4 x max(1,
# max|ref|) per tensor. The fused step's backward recomputes the same eager
# block math; the two steps differ only by the forward's float32 sums in
# another order (K1/K2 against the module's ops, about 1e-6 of the
# activations), carried through 36 blocks.
TOL_TRAIN_GRAD = 1e-4


def _train_setup(precision=None, seed=1):
    """NAFNet-SIDD on the card, every param shifted and beta/gamma drawn from
    a seed; a 2x64x64 batch; an optimizer with lr 0, so that the step leaves
    the params as they were and each param's .grad holds the step's
    gradient."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import TrainState
    model = build_model("nafnet", device="cpu", seed=seed)
    gen = np.random.default_rng(seed)
    with torch.no_grad():
        for name, prm in model.module.named_parameters():
            lo, hi = (-0.2, 0.2) if name.endswith(("beta", "gamma")) else (0.0, 0.02)
            prm.add_(torch.from_numpy(gen.uniform(lo, hi, prm.shape).astype(np.float32)))
    model.to("cuda")
    ref = _rand((2, 64, 64, 3), 0, 1, torch.float32, seed=seed)
    batch = {"image": (ref + _rand(ref.shape, -0.1, 0.1, torch.float32, seed=seed + 1))
             .clamp(0, 1), "ref_image": ref}
    tx = build_optimizer({"optimizer": {"name": "adam", "lr": 0.0}})
    state = TrainState(step=0, module=model.module, optimizer=tx.init(model.module.parameters()))
    return model, tx, state, batch


def _grads_of_step(model, tx, state, batch, **kw):
    from enhax_torch.kernels import nafblock
    from enhax_torch.train import make_train_step
    step = make_train_step(model, tx, **kw)
    before = (nafblock.k1_apply.launches, nafblock.k2_apply.launches)
    metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = (nafblock.k1_apply.launches - before[0], nafblock.k2_apply.launches - before[1])
    grads = {k: p.grad.detach().clone() for k, p in model.module.named_parameters()}
    return metrics["loss"].item(), grads, launches


@pytest.mark.parametrize("remat", [False, True])
def test_fused_train_step_gradients_match_unfused(cuda, remat):
    """K1 = K2 = 8 launches a fused step without remat, 16 with (the
    recompute runs the forward again); none unfused."""
    model, tx, state, batch = _train_setup()
    loss_ref, grads_ref, launches_ref = _grads_of_step(model, tx, state, batch, remat=remat)
    loss, grads, launches = _grads_of_step(model, tx, state, batch, remat=remat, fused=True)
    assert launches_ref == (0, 0)
    assert launches == ((16, 16) if remat else (8, 8))
    assert abs(loss - loss_ref) <= TOL_TRAIN_GRAD * max(1.0, abs(loss_ref))
    for k, g in grads_ref.items():
        scale = max(1.0, g.abs().max().item())
        assert (grads[k] - g).abs().max().item() <= TOL_TRAIN_GRAD * scale, k


@pytest.mark.parametrize("remat", [False, True])
def test_fused_bf16_step_prepares_weights_once_a_step(cuda, remat):
    """bf16-mixed: each step's bf16 copies are new tensors, so K1/K2's
    weights are prepared anew every step (8 blocks x 2 kernels), and only
    once within it, the recompute under remat included."""
    from enhax_torch.kernels import _launch
    from enhax_torch.train import make_train_step
    model, tx, state, batch = _train_setup()
    step = make_train_step(model, tx, remat=remat, precision="bf16-mixed", fused=True)
    for _ in range(2):
        makes = _launch.prepared.makes
        assert torch.isfinite(step(state, batch)["loss"]).item()
        assert _launch.prepared.makes - makes == 16


def test_bf16_weights_are_prepared_anew_after_an_optimizer_step(cuda):
    """bf16 params updated in place by torch.optim (foreach) on the card:
    the next launch prepares anew; until then the prepared weights are kept."""
    from enhax_torch.kernels import _launch, nafblock
    p = _block_params(32, torch.bfloat16)
    x = _rand((2, 9, 40, 32), -1, 1, torch.bfloat16)
    with torch.no_grad():
        nafblock.k1_apply(x, p)
        makes = _launch.prepared.makes
        nafblock.k1_apply(x, p)
        assert _launch.prepared.makes == makes
    opt = torch.optim.AdamW(p.values(), lr=1e-2, foreach=True)
    for q in p.values():
        q.grad = torch.ones_like(q)
    opt.step()
    with torch.no_grad():
        out = nafblock.k1_apply(x, p)
        assert _launch.prepared.makes == makes + 1
        _check_rel(out, nafblock.k1_plain(x, p))


def test_eval_step_runs_the_serving_kernels(cuda):
    from enhax_torch.kernels import nafblock
    from enhax_torch.train import make_eval_step
    model, _, _, batch = _train_setup()
    before = nafblock.k1_apply.launches
    metrics = make_eval_step(model)(model.module, batch)
    assert nafblock.k1_apply.launches == before + 8
    assert all(torch.isfinite(v).item() for v in metrics.values())
    assert set(metrics) == {"psnr", "ssim", "loss"}


# -- Zero-DCE training (fault 3.7) and HINet ---------------------------------------

def _zero_dce_step_grads(model, batch):
    """One zero_dce++_re train step with lr 0 (the params stay; each .grad
    keeps the step's gradient): the loss, the gradients, the curve kernels'
    launches in the step."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import TrainState, make_train_step
    tx = build_optimizer({"optimizer": {"name": "adam", "lr": 0.0}})
    step = make_train_step(model, tx, gradient_clip_val=0.1)
    before = (dce_curve.fused_curve_apply.launches,
              dce_curve.fused_curve_upsample_apply.launches)
    loss = step(TrainState(0, model.module, tx.init(model.module.parameters())), batch)["loss"]
    after = (dce_curve.fused_curve_apply.launches,
             dce_curve.fused_curve_upsample_apply.launches)
    grads = {k: p.grad.detach().cpu() for k, p in model.module.named_parameters()}
    return loss.item(), grads, (after[0] - before[0], after[1] - before[1])


def test_zero_dce_trains_on_the_card(cuda):
    """A zero_dce++_re train step on the card runs the differentiable curve
    loop (counted once; no curve kernel launches) and gives the CPU step's
    loss and gradients within 1e-4 x max(1, max|ref|); the eval forward
    after it serves through the curve kernel, once. A grad-enabled call
    outside training takes the loop too, and is counted."""
    from enhax_torch.models.llie.zero_dce import ZeroDCE
    from enhax_torch.train import make_eval_step
    x = np.random.default_rng(4).uniform(0, 0.3, (2, 64, 96, 3)).astype(np.float32)
    gpu = build_model("zero_dce++_re", device="cuda")
    cpu = build_model("zero_dce++_re", device="cpu")
    loss_ref, ref, _ = _zero_dce_step_grads(cpu, {"image": torch.from_numpy(x)})
    loops = ZeroDCE.curve_loop_forwards
    loss, grads, launches = _zero_dce_step_grads(gpu, {"image": torch.from_numpy(x).cuda()})
    assert launches == (0, 0) and ZeroDCE.curve_loop_forwards == loops + 1
    assert abs(loss - loss_ref) <= 1e-4 * max(1.0, abs(loss_ref))
    for k, g in ref.items():
        assert (grads[k] - g).abs().max().item() <= 1e-4 * max(1.0, g.abs().max().item()), k
    before = dce_curve.fused_curve_apply.launches
    metrics = make_eval_step(gpu)(gpu.module, {"image": torch.from_numpy(x).cuda()})
    assert dce_curve.fused_curve_apply.launches == before + 1
    assert ZeroDCE.curve_loop_forwards == loops + 1
    assert torch.isfinite(metrics["loss"]).item()
    out = gpu.apply({"image": torch.from_numpy(x).cuda()})
    assert dce_curve.fused_curve_apply.launches == before + 1
    assert ZeroDCE.curve_loop_forwards == loops + 2 and out["enhanced"].requires_grad


def test_hinet_on_card_matches_cpu(cuda):
    """hinet_re at the published width (64, depth 5), biases and instance
    norms drawn, float32 with TF32 off."""
    cpu = build_model("hinet_re", device="cpu", seed=1)
    gen = np.random.default_rng(5)
    with torch.no_grad():
        for name, prm in cpu.module.named_parameters():
            if name.endswith("bias") or ".norm." in name:
                prm.add_(torch.from_numpy(gen.uniform(-0.1, 0.1, prm.shape).astype(np.float32)))
    gpu = build_model("hinet_re", device="cpu", seed=1)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    x = gen.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})
        oc = cpu.apply({"image": torch.from_numpy(x)})
    for key in ("stage1", "enhanced"):
        scale = max(1.0, oc[key].abs().max().item())
        assert (og[key].cpu() - oc[key]).abs().max().item() <= 1e-4 * scale, key


@pytest.mark.parametrize("tile", [None, (32, 32, 8)])
def test_predictor_serves_hinet_on_card(cuda, tile):
    """A bf16 Predictor (padding 61x83 to 64x96; or hinet_tiny_tiled's tile
    spec at the published width): both outputs, float32, finite, within
    3e-2 x max(1, max|ref|) of the float32 Predictor's (every op's output
    rounds to bf16: about 1e-2 on the CPU, tests/test_torch_hinet.py)."""
    model = build_model("hinet_re")
    x = np.random.default_rng(6).uniform(0, 1, (61, 83, 3)).astype(np.float32)
    ref = Predictor(model, tile=tile, tile_blend="uniform").infer({"image": x})
    out = Predictor(model, tile=tile, tile_blend="uniform", bf16=True).infer({"image": x})
    for key in ("stage1", "enhanced") if tile is None else ("enhanced",):
        y = out[key]
        assert y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (1, 61, 83, 3)
        assert torch.isfinite(y).all()
        assert (y - ref[key]).abs().max().item() <= 3e-2 * max(1.0, ref[key].abs().max().item())


# -- Restormer-Rain13k training and the instance path (Zero-DCE-V) -------------------

RAIN13K = "configs/restormer_rain13k.py"


def _rain(shape, seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, shape).astype(np.float32)
    rain = np.clip(ref + rng.uniform(0, 0.3, shape), 0, 1).astype(np.float32)
    return {"image": torch.from_numpy(rain), "ref_image": torch.from_numpy(ref)}


def _restormer_trainer(device):
    """restormer at the published width with configs/restormer_rain13k.py's
    AdamW, cyclic schedule, remat and EMA; temperature and LayerNorms drawn."""
    from pathlib import Path

    from enhax_torch.train import Trainer
    from enhax_torch.utils.config import load_config
    cfg = load_config(Path(__file__).resolve().parents[1] / RAIN13K)
    model = build_model("restormer", device="cpu", seed=3, **cfg["model_cfg"])
    gen = np.random.default_rng(7)
    with torch.no_grad():
        for name, prm in model.module.named_parameters():
            if name.endswith("temperature"):
                prm.copy_(torch.from_numpy(gen.uniform(0.5, 3.0, prm.shape).astype(np.float32)))
            elif ".body." in name:
                prm.add_(torch.from_numpy(gen.uniform(-0.2, 0.2, prm.shape).astype(np.float32)))
    model.to(device)
    tr = Trainer(model, cfg["optimizer_cfg"], remat=True, ema_decay=0.999)
    return model, tr, tr.init_state()


def test_restormer_train_step_on_card_matches_cpu(cuda):
    """One float32 step at the published width on 1x64x64 (TF32 off): loss,
    every gradient and the EMA shadow within 1e-4 x max(1, max|ref|) of the
    CPU step's; no R1/R2 launch in the step."""
    from enhax_torch.kernels import restormer_block as rb
    batch = _rain((1, 64, 64, 3), 8)
    res = {}
    for dev in ("cpu", "cuda"):
        model, tr, state = _restormer_trainer(dev)
        assert model.param_count() == 26_126_644
        before = rb.r1_apply.launches, rb.r2_apply.launches
        loss = tr._train_step(state, {k: v.to(dev) for k, v in batch.items()})["loss"].item()
        assert (rb.r1_apply.launches, rb.r2_apply.launches) == before
        res[dev] = (loss, {k: p.grad.cpu() for k, p in state.module.named_parameters()},
                    {k: v.cpu() for k, v in state.ema.state_dict().items()})
    (loss_ref, g_ref, e_ref), (loss, g, e) = res["cpu"], res["cuda"]
    assert abs(loss - loss_ref) <= 1e-4 * max(1.0, abs(loss_ref))
    for got, ref in ((g, g_ref), (e, e_ref)):
        for k, t in ref.items():
            assert (got[k] - t).abs().max().item() <= 1e-4 * max(1.0, t.abs().max().item()), k


def test_restormer_eval_after_steps_reprepares_and_matches_the_module(cuda):
    """The eval step on the EMA shadow at 1x128x128 after each of three
    steps: R1 = R2 = 36 launches (the latent's 8 blocks at 16x16 run the
    module's), 72 prepared weights after a step and none on a second eval;
    after three steps the fused forward of the shadow within 1e-4 x max(1,
    max|ref|) of its module forward, and its mean |d| within 1e-4 x max(1,
    mean|ref|)."""
    import dataclasses

    from enhax_torch.kernels import _launch
    from enhax_torch.kernels import restormer_block as rb
    from enhax_torch.train import make_eval_step
    model, tr, state = _restormer_trainer("cuda")
    val = {k: v.cuda() for k, v in _rain((1, 128, 128, 3), 9).items()}
    eval_step = make_eval_step(model)
    made = []
    for i in range(3):
        tr._train_step(state, {k: v.cuda() for k, v in _rain((1, 64, 64, 3), 10 + i).items()})
        for _ in range(2 if i == 0 else 1):
            before = _launch.prepared.makes, rb.r1_apply.launches, rb.r2_apply.launches
            eval_step(state.ema, val)
            assert (rb.r1_apply.launches - before[1], rb.r2_apply.launches - before[2]) == (36, 36)
            made.append(_launch.prepared.makes - before[0])
    assert made == [72, 0, 72, 72]
    with torch.inference_mode():
        fused = dataclasses.replace(model, module=state.ema).apply(val)["enhanced"]
        plain = state.ema(val["image"])["enhanced"]
    d = (fused - plain).abs()
    assert d.max().item() <= 1e-4 * max(1.0, plain.abs().max().item())
    assert d.mean().item() <= 1e-4 * max(1.0, plain.abs().mean().item())


@pytest.mark.parametrize("b", [1, 2])
def test_curve_kernel_at_the_instance_shape(cuda, b):
    """fused_curve_apply at zero_dce_v's (B, 256, 256, 1) with 15 per-iteration
    curves, float32, within 1e-5 of its plain version; one launch."""
    x = _rand((b, 256, 256, 1), 0, 0.3, torch.float32, seed=11)
    r = _rand((b, 256, 256, 15), -1, 1, torch.float32, seed=12)
    before = dce_curve.fused_curve_apply.launches
    out = dce_curve.fused_curve_apply(x, r, num_iters=15, shared=False)
    assert dce_curve.fused_curve_apply.launches == before + 1
    _check(out, dce_curve.fused_curve_apply_plain(x, r, 15, False))


def test_zero_dce_v_predictor_on_card_matches_cpu(cuda):
    """zero_dce_v (32 channels, 15 curves, down size 256) through Predictor
    with a 3-step fit at 512x512: fit_loss and the enhanced image within
    1e-4 x max(1, max|ref|) of the CPU fit's; one fused_curve_apply launch
    (the clean forward), the curve loop in each fit step."""
    import copy
    import dataclasses

    from enhax_torch.models.llie.zero_dce import ZeroDCE
    cpu = build_model("zero_dce_v", device="cpu", seed=100)
    cpu = dataclasses.replace(cpu, instance_steps=3)
    gpu = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module))
    x = np.random.default_rng(13).uniform(0, 0.3, (512, 512, 3)).astype(np.float32)
    ref = Predictor(cpu, device="cpu")({"image": x})
    before, loops = dce_curve.fused_curve_apply.launches, ZeroDCE.curve_loop_forwards
    out = Predictor(gpu)({"image": x})
    assert dce_curve.fused_curve_apply.launches == before + 1
    assert ZeroDCE.curve_loop_forwards == loops + 3
    assert abs(float(out["fit_loss"]) - float(ref["fit_loss"])) <= 1e-4 * max(
        1.0, abs(float(ref["fit_loss"])))
    e, e_ref = out["enhanced"].cpu(), ref["enhanced"]
    assert e.shape == (1, 512, 512, 3)
    assert (e - e_ref).abs().max().item() <= 1e-4 * max(1.0, e_ref.abs().max().item())


# -- the rest of the instance models (CoLIE, ZID) ---------------------------------------

@pytest.mark.parametrize("name, kw, hw, fit_dtype", [
    ("colie_re", {"down_size": 32, "hidden_dim": 16}, 48, torch.float32),
    ("zid", {"image_size": (64, 64)}, 64, torch.float32),
    ("zero_restore_llie", {}, 64, torch.float64), ("zero_restore_dehaze", {}, 64, torch.float64),
    ("zero_restore_uie", {}, 64, torch.float64)])
def test_instance_model_on_card_matches_cpu(cuda, name, kw, hw, fit_dtype):
    """colie_re and zid at a small size, and Zero-Restore's three variants
    at their width (64 channels) on 64x64, on the card against the CPU (f32,
    TF32 off): every output of the clean forward, and a 3-step fit's
    fit_loss and enhanced image within 1e-4 x max(1, max|ref|) (the fit in
    ``fit_dtype`` on both devices); the fitted parameters (ZID's BatchNorm
    statistics among them) each within 1e-4 x max(1, mean|ref|) on mean|d|
    and within Adam's reach, 2 x 3 x lr, on max|d|; a float32 Predictor
    request of 3 steps as well."""
    import copy
    import dataclasses

    from enhax_torch.infer.engine import fit_instance

    def gap(a, b):
        return (a.float().cpu() - b).abs().max().item() / max(1.0, b.abs().max().item())

    cpu = dataclasses.replace(build_model(name, device="cpu", seed=3, **kw), instance_steps=3)
    gpu = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module).cuda())
    lo, hi = (0.4, 0.95) if name == "zid" else (0.02, 0.3)
    x = np.random.default_rng(14).uniform(lo, hi, (1, hw, hw, 3)).astype(np.float32)
    bc, bg = {"image": torch.from_numpy(x)}, {"image": torch.from_numpy(x).cuda()}
    with torch.inference_mode():
        ref, out = cpu.apply(bc), gpu.apply(bg)
    for k, r in ref.items():
        if isinstance(r, torch.Tensor) and r.ndim:
            assert gap(out[k], r) <= 1e-4, k
    # the fit in fit_dtype on both devices: Zero-Restore's in float64, where
    # Adam's first step takes each weight's sign from its gradient and a
    # gradient within float32 noise of 0 would take the device's rounding
    # (its output divides by t: float32 fits part by ~6e-4)
    cm, gm = (dataclasses.replace(m, module=copy.deepcopy(m.module).to(fit_dtype))
              for m in (cpu, gpu))
    bc, bg = ({k: v.to(fit_dtype) for k, v in b.items()} for b in (bc, bg))
    fits = [fit_instance(m, b, 3, m.instance_lr, m.instance_weight_decay)
            for m, b in ((cm, bc), (gm, bg))]
    (fc, lc), (fg, lg) = fits
    assert abs(float(lg) - float(lc)) <= 1e-4 * max(1.0, abs(float(lc)))
    state_c = dict(fc.module.named_parameters())
    for k, p in fg.module.named_parameters():
        # each tensor's mean|d| to 1e-4; an element whose gradient is within
        # float32 noise of 0 moves by about +-lr a step whatever its sign
        d, r = (p.detach().cpu() - state_c[k].detach()).abs(), state_c[k].detach().abs()
        assert d.mean().item() <= 1e-4 * max(1.0, r.mean().item()), k
        assert d.max().item() <= 2 * 3 * cpu.instance_lr * max(1.0, r.max().item()), k
    with torch.inference_mode():
        assert gap(fg.apply(bg)["enhanced"], fc.apply(bc)["enhanced"].float()) <= 1e-4
    if fit_dtype != torch.float32:
        return   # Predictor serves in float32 (it casts a float64 image)
    ref = Predictor(cpu, device="cpu")({"image": x})
    out = Predictor(gpu)({"image": x})
    assert gap(out["enhanced"], ref["enhanced"]) <= 1e-4
    assert abs(float(out["fit_loss"]) - float(ref["fit_loss"])) <= 1e-4 * max(
        1.0, abs(float(ref["fit_loss"])))


def _photo(seed: int, h: int = 200, w: int = 296) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.uniform(0, 1, (1, 3, h // 16, w // 16)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bicubic",
                                         align_corners=False).clamp(0, 1)
    x = 0.1 + 0.8 * up[0].permute(1, 2, 0).numpy() + rng.normal(0, 0.02, (h, w, 3))
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_niqe_and_brisque_features_on_card_match_cpu(cuda, seed):
    """NIQE's and BRISQUE's features of a photo-like 200x296 image on the
    card against the CPU: the sharpness mask equal; the shape parameters
    (a grid of 0.001) equal or one step apart (a near tie resolved the
    other way by the other device's float32 sums), every other feature
    within 1e-4 x max(1, max|ref|) but an AGGD mean beside a stepped shape
    parameter; the official pipeline's score within 1e-2 (a step moves it
    by up to 0.76%)."""
    from enhax_torch.nn import brisque, niqe
    x = torch.from_numpy(_photo(seed))
    alphas = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]
    (fc, wc), (fg, wg) = niqe.niqe_features(x), niqe.niqe_features(x.cuda())
    bc, bg = brisque.brisque_features(x), brisque.brisque_features(x.cuda())
    assert torch.equal(wg.cpu(), wc)
    for card, cpu in ((fg.cpu(), fc), (bg.cpu()[None], bc[None])):
        steps = (card[:, alphas] - cpu[:, alphas]).abs() / 1e-3
        assert steps.max().item() <= 1.0 + 1e-3
        for c in range(36):
            if c in alphas:
                continue
            keep = slice(None)
            if c - 1 in alphas and c - 1 not in (0, 18):   # an AGGD mean
                keep = steps[:, alphas.index(c - 1)] < 1e-3
            d = (card[keep, c] - cpu[keep, c]).abs()
            scale = max(1.0, cpu[:, c].abs().max().item())
            assert d.numel() == 0 or d.max().item() <= 1e-4 * scale, c
    params = {"mu": fc.mean(0).numpy().astype(np.float64), "impl": "official",
              "cov": np.cov(fc.numpy().T.astype(np.float64)) + 1e-3 * np.eye(36),
              "gaussian_window": niqe._fspecial_gaussian_np()}
    ref = niqe.niqe_official(x, params)
    assert abs(niqe.niqe_official(x.cuda(), params) - ref) <= 1e-2 * max(1.0, abs(ref))


# -- the low-light and retouch families (slice 15): no kernel of the port --------------

def _cidnet_pair(seed=6):
    """hvi_cidnet_re at the published width on the CPU and the card, the
    temperatures drawn away from their init (ones), so that a fault in
    their use shows."""
    cpu = build_model("hvi_cidnet_re", device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in cpu.module.named_parameters():
            if name.endswith("temperature"):
                p.copy_(0.3 + 2.7 * torch.rand(p.shape, generator=gen))
    card = build_model("hvi_cidnet_re", device="cuda", seed=seed)
    card.module.load_state_dict(cpu.module.state_dict())
    return cpu, card


def _cidnet_gap(out, ref) -> tuple:
    """(mean|d|, max|d|) and whether they keep chip_smoke's bounds."""
    import chip_smoke
    d = (out - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    gaps = d.mean().item(), d.max().item()
    return gaps, (gaps[0] <= chip_smoke.TOL_CIDNET_BF16_MEAN * scale
                  and gaps[1] <= chip_smoke.TOL_CIDNET_BF16_MAX * scale)


def test_hvi_cidnet_bf16_serving_matches_float32(cuda):
    """hvi_cidnet_re (channels (36, 36, 72, 144), heads (1, 2, 4, 8)) served
    on the card in bf16 within chip_smoke.py's bounds of its float32 serving
    (the mean |d| within 3e-2, the max within 0.3, x max(1, max|ref|)), and
    its float32 serving within 1e-4 x max(1, max|ref|) of the CPU's."""
    cpu, card = _cidnet_pair()
    img = np.random.default_rng(15).uniform(0, 0.4, (2, 256, 192, 3)).astype(np.float32)
    out = Predictor(card, device="cuda", bf16=True)({"image": img})["enhanced"].float().cpu()
    ref = Predictor(card, device="cuda")({"image": img})["enhanced"].float().cpu()
    gaps, held = _cidnet_gap(out, ref)
    print(f"hvi_cidnet_re bf16 vs float32: mean|d| {gaps[0]:.4e}, max|d| {gaps[1]:.4e}")
    assert held, gaps
    x = img[:1, :128, :128]
    out = Predictor(card, device="cuda")({"image": x})["enhanced"].float().cpu()
    ref = Predictor(cpu, device="cpu")({"image": x})["enhanced"].float()
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


def test_hvi_cidnet_bf16_bound_catches_a_missing_temperature(cuda, monkeypatch):
    """The bound above fails a planted fault: bf16 serving whose cross
    attention leaves out its per-head temperature reads above it."""
    from enhax_torch.models.llie import hvi_cidnet as cid
    _, card = _cidnet_pair()
    img = np.random.default_rng(15).uniform(0, 0.4, (2, 256, 192, 3)).astype(np.float32)
    ref = Predictor(card, device="cuda")({"image": img})["enhanced"].float().cpu()
    forward = cid.CrossCAB.forward

    def without_temperature(self, x, y):
        saved = self.temperature.data.clone()
        self.temperature.data.fill_(1.0)
        try:
            return forward(self, x, y)
        finally:
            self.temperature.data.copy_(saved)

    monkeypatch.setattr(cid.CrossCAB, "forward", without_temperature)
    out = Predictor(card, device="cuda", bf16=True)({"image": img})["enhanced"].float().cpu()
    gaps, held = _cidnet_gap(out, ref)
    print(f"hvi_cidnet_re bf16 without its temperature: mean|d| {gaps[0]:.4e}, "
          f"max|d| {gaps[1]:.4e}")
    assert not held, gaps


def test_zero_ig_local_variance_gradient_on_card_matches_cpu(cuda):
    """ZERO-IG's zero-padded 5x5 moments on a channels-last map (as its
    maps, permuted from NHWC, are): the gradient on the card within 1e-12 of
    the CPU's in float64. torch's CUDA ``avg_pool2d`` with ``padding`` puts
    0.38 into that gradient; the port pads first."""
    from enhax_torch.models.llie import zero_ig as zig
    x = torch.rand(2, 3, 64, 64, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    w = torch.rand(x.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", "cuda"):
        inp = x.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        (zig._local_var5(inp) * w.to(dev)).sum().backward()
        grads.append(inp.grad.cpu())
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-12


FAMILIES = [("gcenet", {"num_channels": 8, "num_iters": 4, "use_depth": False}, 64),
            ("gcenet_zsn2n", {"num_channels": 8, "num_iters": 4, "use_depth": False}, 64),
            ("zero_ig_re", {"num_channels": 16, "embed_channels": 12}, 64),
            ("psenet", {"base_channels": 8}, 64),
            ("hvi_cidnet_re", {}, 64),
            ("lyt_net_re", {"filters": 16}, 128),
            ("llunet++_re", {"filters": (8, 16, 16, 32, 32)}, 64),
            ("lllinet", {"filters": (8, 16, 16, 32, 32)}, 64),
            ("lllinet_hvi", {"filters": (8, 16, 16, 32, 32)}, 64),
            ("neurop_re", {"base_nf": 16, "encode_nf": 8}, 96),
            ("neurop_init", {"base_nf": 16}, 64)]


@pytest.mark.parametrize("name, kw, hw", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_first_train_step_on_card_matches_cpu(cuda, name, kw, hw):
    """Each family's first train step (forward, loss, backward) on the card
    against the CPU's on the same weights and batch, TF32 off
    (``chip_smoke.family_check``): the loss and every gradient within 1e-4
    x max(1, max|ref|) in float32; for chip_smoke.FAMILY_FLOAT64, whose
    float32 gradients rounding amplifies, in float64, and the card's float32
    each within 4x the CPU's own float32 gap of the CPU's float64 (psenet's
    pseudo-ground-truth draws the same from its own generator)."""
    import chip_smoke
    gen = np.random.default_rng(16)
    batch = chip_smoke.family_batch(name, 2, hw, gen)
    gaps, bounds, (loss, ref_loss) = chip_smoke.family_check(name, kw, 4, batch)
    print(f"{name}: loss {loss:.6f} / {ref_loss:.6f}, gaps {gaps} (bounds {bounds})")
    assert all(gaps[k] <= bounds[k] for k in bounds), gaps


ZERO_REF = [("zero_didce", {"num_channels": 16}), ("sgz", {"num_channels": 16}), ("sci", {}),
            ("ruas", {}), ("pairlie", {"num": 16}), ("rsfnet", {})]


@pytest.mark.parametrize("name, kw", ZERO_REF, ids=[z[0] for z in ZERO_REF])
def test_zero_ref_first_train_step_on_card_matches_cpu(cuda, name, kw):
    """The small zero-reference models' first train step on the card against
    the CPU's on the same weights and a 2x64x64 batch, float32, TF32 off
    (``chip_smoke.family_check``): the loss and every gradient within 1e-4 x
    max(1, max|ref|); sci and rsfnet (chip_smoke.FAMILY_FLOAT64) in float64,
    the card's float32 within 4x the CPU's own float32 gap."""
    import chip_smoke
    gen = np.random.default_rng(17)
    batch = {"image": chip_smoke.zero_ref_image(gen, 2, 64)}
    gaps, bounds, (loss, ref_loss) = chip_smoke.family_check(name, kw, 5, batch)
    print(f"{name}: loss {loss:.6f} / {ref_loss:.6f}, gaps {gaps} (bounds {bounds})")
    assert all(gaps[k] <= bounds[k] for k in bounds), gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 528, 396, 3), (2, 36, 60, 3)])
def test_shared_curve_kernel_at_sgz_shapes(cuda, dtype, shape):
    x = _rand(shape, 0, 0.3, dtype)
    r = _rand(shape, -1, 1, dtype, seed=1)
    before = dce_curve.fused_curve_apply.launches
    out = dce_curve.fused_curve_apply(x, r, num_iters=8, shared=True)
    assert dce_curve.fused_curve_apply.launches == before + 1
    _check(out, dce_curve.fused_curve_apply_plain(x, r, num_iters=8, shared=True))


def test_sgz_serves_through_the_shared_curve_kernel(cuda):
    """A 61x53 request (padded to 72x60 by SGZ's divisor 12) through
    ``Predictor`` on the card: one ``fused_curve_apply`` launch, the output
    and the curve within 1e-4 x max(1, max|ref|) of the CPU's."""
    cpu = build_model("sgz", device="cpu", seed=3, num_channels=16)
    card = build_model("sgz", seed=3, num_channels=16)
    x = np.random.default_rng(18).uniform(0.02, 0.3, (61, 53, 3)).astype(np.float32)
    ref = Predictor(cpu, device="cpu")({"image": x})
    before = dce_curve.fused_curve_apply.launches
    out = Predictor(card)({"image": x})
    assert dce_curve.fused_curve_apply.launches == before + 1
    for k in ("enhanced", "adjust"):
        assert out[k].shape == ref[k].shape == (1, 61, 53, 3)
        err = (out[k].cpu() - ref[k]).abs().max().item()
        assert err <= 1e-4 * max(1.0, ref[k].abs().max().item()), (k, err)


def test_sgz_train_step_launches_no_kernel(cuda):
    """A training forward of SGZ on the card takes the differentiable curve
    loop (no launch); its loss within 1e-4 of the CPU's."""
    cpu = build_model("sgz", device="cpu", seed=4, num_channels=16)
    card = build_model("sgz", seed=4, num_channels=16)
    x = torch.from_numpy(np.random.default_rng(19).uniform(0.02, 0.3, (2, 48, 48, 3)).astype(
        np.float32))
    before = dce_curve.fused_curve_apply.launches
    loss, _ = card.forward_loss({"image": x.cuda()})
    loss.backward()
    assert dce_curve.fused_curve_apply.launches == before
    ref, _ = cpu.forward_loss({"image": x})
    assert abs(loss.item() - ref.item()) <= 1e-4 * max(1.0, abs(ref.item()))


def test_dcn_forward_and_backward_on_card_match_cpu(cuda):
    """The DCNv2 at a ragged size, with offsets past every border (some
    far), on the card against the CPU: the forward in float32 within 1e-5 x
    max(1, max|ref|) (TF32 off); the gradients of x, offset, mask and
    weight in float64 on both devices within 1e-10 x max|ref| (the card's
    scatter-add of the gather's backward sums in no fixed order)."""
    from enhax_torch.nn.deform import modulated_deform_conv2d
    rng = np.random.default_rng(31)
    b, h, w, c, cout = 2, 37, 53, 16, 12
    off = rng.uniform(-2.5, 2.5, (b, h, w, 18))
    off[:, :2, :, 0::2] -= 3.0
    off[:, :, -2:, 1::2] += 40.0
    arrays = [rng.normal(0, 1, (b, h, w, c)), off, rng.uniform(0, 1, (b, h, w, 9)),
              rng.normal(0, 1 / 12, (cout, c, 3, 3))]
    cpu32 = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    ref = modulated_deform_conv2d(*cpu32)
    out = modulated_deform_conv2d(*(t.cuda() for t in cpu32)).cpu()
    assert (out - ref).abs().max().item() <= TOL_F32 * max(1.0, ref.abs().max().item())
    g = torch.tensor(rng.normal(0, 1, (b, h, w, cout)))
    grads = {}
    for dev in ("cpu", "cuda"):
        args = [torch.tensor(a, dtype=torch.float64, device=dev, requires_grad=True)
                for a in arrays]
        (modulated_deform_conv2d(*args) * g.to(dev)).sum().backward()
        grads[dev] = [a.grad.cpu() for a in args]
    for name, got, want in zip(("x", "offset", "mask", "weight"), grads["cuda"], grads["cpu"]):
        assert (got - want).abs().max().item() <= 1e-10 * want.abs().max().item(), name


def test_adair_bf16_forward_runs_on_card(cuda):
    """AdaIR in bf16 on the card (torch's CUDA FFT takes no bf16: the
    frequency split casts to float32), with fre_n 8 so that a box is not
    empty at 64x64: finite, within 5e-2 x max(1, max|ref|) of float32 on
    the max (the CPU's own bf16 read 2.7-3.0e-2 at this narrow width)."""
    model = build_model("adair", device="cuda", dim=16, num_blocks=(1, 1, 1, 1),
                        num_refinement=1, fre_n=8)
    x = _rand((2, 64, 64, 3), 0, 1, torch.float32, seed=3)
    outs = [Predictor(model, bf16=b).infer({"image": x})["enhanced"] for b in (False, True)]
    assert torch.isfinite(outs[1]).all()
    scale = max(1.0, outs[0].abs().max().item())
    assert (outs[1] - outs[0]).abs().max().item() <= 5e-2 * scale


@pytest.mark.parametrize("name, kw", [
    ("mprnet", {"channels": 16, "s_unet": 8, "s_ors": 8, "num_cab": 2}),
    ("airnet", {"n_feats": 16, "n_groups": 2, "n_blocks": 2}),
    ("adair", {"dim": 16, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "fre_n": 8})])
def test_multitask_step_on_card_matches_cpu(cuda, name, kw):
    """A narrow model's served forward, train step (AirNet's on its batch's
    statistics) and updated statistics on the card against the CPU's
    (``chip_smoke.multitask_step``), float32, TF32 off: 1e-4 x max(1,
    max|ref|) a tensor."""
    import chip_smoke
    batch = chip_smoke.multitask_batch(name, 2, b=2)
    steps = {}
    for dev in ("cpu", "cuda"):
        model = build_model(name, device=dev, seed=4, **kw)
        steps[dev] = chip_smoke.multitask_step(model, {k: v.to(dev) for k, v in batch.items()})
    gaps = chip_smoke.step_gaps_all(steps["cuda"], steps["cpu"], name)
    print(f"{name}: {gaps}")
    assert all(gaps[k] <= 1e-4 for k in ("loss", "served", "outputs", "grads", "stats")), gaps
