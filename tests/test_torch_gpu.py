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


# -- the fused RestormerBlock kernels --------------------------------------------

RESTORMER_WIDTHS = [(48, 1), (96, 1), (96, 2), (192, 4), (384, 8)]


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


@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
def test_forms_by_width(cuda, c, heads):
    """bf16 takes the bf16 forms at every width; float32 keeps the general
    forms."""
    from enhax_torch.kernels import restormer_block as rb
    assert rb.design(1, c, heads) == {"r1": "bf16", "r2": "bf16"}
    assert rb.design(0, c, heads) == {"r1": "general", "r2": "general"}


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

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, heads", RESTORMER_WIDTHS)
@pytest.mark.parametrize("shape", [(2, 19, 29), (1, 1, 37)])
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
