"""Port parity: NAFNet-TLC against the JAX package, on the CPU in float32.

Layers, the box filter and TLC mean, the fused NAFBlock's plain versions
(which the wrappers run on the CPU) against the Pallas kernels in interpret
mode, the block and the network, the weight bridge, Predictor and the
predict CLI. One set of JAX weights goes through ``jax_to_torch_state_dict``
into the port. Tolerances: 1e-5 * max(1, max|ref|) for layers, kernels and
blocks, 1e-4 * max(1, max|ref|) for a whole model.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enhax
import enhax_torch
from enhax.infer import Predictor as JaxPredictor
from enhax.kernels import nafblock as jnaf
from enhax.kernels.box import box_mean_fast as jax_box_mean_fast
from enhax.models.base import build_model as jax_build_model
from enhax.models.multitask.nafnet import NAFBlock as JaxNAFBlock
from enhax.nn import layers as jl
from enhax.ops.filtering import box_filter as jax_box_filter
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.kernels import nafblock
from enhax_torch.kernels.box import box_mean_fast
from enhax_torch.models.base import build_model
from enhax_torch.models.multitask.nafnet import NAFBlock
from enhax_torch.nn import layers
from enhax_torch.ops.filtering import box_filter
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_MODEL = 1e-4
TINY = {"width": 8, "middle_blk_num": 1, "enc_blk_nums": (1, 1), "dec_blk_nums": (1, 1)}
# the Pallas kernels in interpret mode, jitted: several times faster than
# eager interpretation, and one compile per shape across the cases
jax_k1 = jax.jit(jnaf.k1_apply, static_argnames="interpret")
jax_k2 = jax.jit(jnaf.k2_apply, static_argnames=("pooled_spatial", "interpret"))


def flat_params(variables) -> dict:
    """The flat-key format of enhax.train.checkpoints.save_params_npz."""
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf)
    return flat


def assert_close(out, ref, tol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = np.abs(out - ref)
    assert err.max() <= tol * scale, (err.max(), tol * scale)
    return err


def assert_edges_like_interior(err):
    """The first and last rows and columns (the dw conv's zero padding)
    are no worse than twice the interior."""
    inner = max(float(err[:, 1:-1, 1:-1].max()), 1e-7)
    for edge in (err[:, 0], err[:, -1], err[:, :, 0], err[:, :, -1]):
        assert edge.max() <= 2 * inner, (edge.max(), inner)


def shifted(params, shift: float):
    """Every param + shift: beta and gamma leave their zero init, so the
    whole block is exercised."""
    return jax.tree_util.tree_map(lambda a: a + np.float32(shift), params)


def random_variables(jm, seed: int):
    """Variables of the JAX model's structure with values drawn by numpy
    (quicker than flax's init on the CPU); beta and gamma nonzero."""
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 16, 16, 3))})
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name in ("beta", "gamma"):
            a = rng.uniform(-0.5, 0.5, s.shape)
        elif name == "scale":
            a = 1 + rng.uniform(-0.2, 0.2, s.shape)
        elif name == "bias":
            a = rng.uniform(-0.1, 0.1, s.shape)
        else:
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, struct)


def port_block(jax_params, c: int, tlc=None) -> NAFBlock:
    """A port NAFBlock holding the JAX block's params, through the bridge."""
    flat = {f"params/enc0_0/{k}": v for k, v in flat_params(jax_params).items()}
    sd = jax_to_torch_state_dict("nafnet_local", flat)
    blk = NAFBlock(c, tlc_window=tlc)
    blk.load_state_dict({k.removeprefix("encoders.0.0."): v for k, v in sd.items()})
    return blk


def nhwc(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# -- layers --------------------------------------------------------------------

def test_layernorm2d_matches_jax(rng):
    x = nhwc(rng, (2, 5, 7, 16), -2, 3)
    jm = jl.LayerNorm2d()
    v = shifted(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0.3)
    ln = layers.LayerNorm2d(16)
    ln.load_state_dict({"weight": torch.tensor(np.asarray(v["params"]["scale"])),
                        "bias": torch.tensor(np.asarray(v["params"]["bias"]))})
    assert_close(ln(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("c", [8, 128])
def test_dwconv3x3_matches_jax(rng, c):
    """At C=8 the JAX layer runs shifted adds, at C=128 the grouped conv."""
    x = nhwc(rng, (2, 9, 11, c))
    jm = jl.DWConv3x3(c)
    v = shifted(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 0.1)
    flat = {f"params/enc0_0/conv2/{k}": a for k, a in flat_params(v["params"]).items()}
    sd = jax_to_torch_state_dict("nafnet_local", flat)
    conv = layers.DWConv3x3(c)
    conv.load_state_dict({k.removeprefix("encoders.0.0.conv2."): a for k, a in sd.items()})
    assert_close(conv(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_conv1x1_matches_jax(rng):
    x = nhwc(rng, (2, 5, 7, 16))
    jm = jl.conv1x1(24)
    v = shifted(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), 0.1)
    flat = {f"params/enc0_0/conv1/{k}": a for k, a in flat_params(v["params"]).items()}
    sd = jax_to_torch_state_dict("nafnet_local", flat)
    conv = layers.conv1x1(16, 24)
    conv.load_state_dict({k.removeprefix("encoders.0.0.conv1."): a for k, a in sd.items()})
    assert_close(conv(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["pixel_shuffle", "pixel_unshuffle"])
def test_pixel_shuffle_matches_jax(rng, fn):
    x = nhwc(rng, (2, 6, 8, 12))
    out = getattr(layers, fn)(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(jl, fn)(jnp.asarray(x), 2)))


def test_pixel_shuffle_is_torchs():
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    ref = torch.nn.functional.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(layers.pixel_shuffle(x, 2), ref)
    assert torch.equal(layers.pixel_unshuffle(ref, 2), x)


# -- box filter and the TLC mean -------------------------------------------------

@pytest.mark.parametrize("radius", [1, 3, 20])
def test_box_filter_matches_jax(rng, radius):
    x = nhwc(rng, (2, 9, 13, 4), 0, 1)
    assert_close(box_filter(torch.from_numpy(x), radius), jax_box_filter(jnp.asarray(x), radius))


@pytest.mark.parametrize("radius", [5, 40])
def test_box_mean_fast_matches_jax(rng, radius):
    """r=40 > H and W: every window is the whole image."""
    x = nhwc(rng, (2, 16, 24, 8), 0, 1)
    out = box_mean_fast(torch.from_numpy(x), radius)
    assert out.dtype == torch.float32
    assert_close(out, jax_box_mean_fast(jnp.asarray(x), radius))
    xb = torch.from_numpy(x).bfloat16()
    assert box_mean_fast(xb, radius).dtype == torch.bfloat16


# -- the fused NAFBlock's plain versions against the Pallas kernels -------------

def _block(rng, c, shift, tlc=None):
    x = nhwc(rng, (2, 16, 24, c), 0, 1)
    jblk = JaxNAFBlock(c, tlc_window=tlc)
    p = shifted(jblk.init(jax.random.PRNGKey(c), jnp.asarray(x))["params"], shift)
    return x, jblk, p, port_block(p, c, tlc)


@pytest.mark.parametrize("shift", [0.05, 0.5])
@pytest.mark.parametrize("c", [8, 16])
def test_k1_plain_matches_jax_kernel(rng, c, shift):
    x, _, p, blk = _block(rng, c, shift)
    ref = jax_k1(jnp.asarray(x), p, interpret=True)
    with torch.no_grad():
        out = nafblock.k1_apply(torch.from_numpy(x), dict(blk.named_parameters()))
    assert_edges_like_interior(assert_close(out, ref))
    assert nafblock.k1_apply.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("shift", [0.05, 0.5])
@pytest.mark.parametrize("c", [8, 16])
def test_k2_plain_matches_jax_kernel(rng, c, shift, spatial):
    x, _, p, blk = _block(rng, c, shift)
    g = nhwc(rng, x.shape)
    pooled = nhwc(rng, x.shape if spatial else (2, 1, 1, c))
    ref = jax_k2(jnp.asarray(x), jnp.asarray(g), jnp.asarray(pooled), p,
                 pooled_spatial=spatial, interpret=True)
    with torch.no_grad():
        out = nafblock.k2_apply(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(pooled), dict(blk.named_parameters()))
    assert_edges_like_interior(assert_close(out, ref))
    assert nafblock.k2_apply.launches == 0


# the main path's widths, in float32 and in bfloat16 (x and params), on a
# small image and a one-row image: they pin the rounding points of the
# kernels' bf16 forms. Tolerance: 1e-5 (float32) or one bf16 step, 2^-6,
# (bfloat16) times max(1, max|ref|)
TOL_BF16 = 2.0 ** -6
MAIN_WIDTHS = [(c, dt, hw) for c in (32, 64) for dt in ("float32", "bfloat16")
               for hw in ((2, 16, 24), (1, 1, 24))]


def _main_width_block(rng, c, dt, hw):
    """x, the JAX params and the port's params at width c in dtype dt: the
    init shifted by 0.05 (shifted by 0.5, every 1x1 weight is near 0.5 and
    K2's output at C=32 reaches 735, where float32 sums in another order
    differ by 1e-5 of it)."""
    x, _, p, blk = _block(rng, c, 0.05)
    x = nhwc(rng, hw + (c,), 0, 1)
    if dt == "bfloat16":
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        blk = blk.to(torch.bfloat16)
    return jnp.asarray(x, dt), p, dict(blk.named_parameters())


def _port(a: jnp.ndarray) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 by its bits)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a.view(jnp.uint16)).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_close_in(out: torch.Tensor, ref: jnp.ndarray, dt: str):
    assert str(out.dtype).endswith(dt) and ref.dtype == jnp.dtype(dt)
    tol = TOL if dt == "float32" else TOL_BF16
    return assert_close(out.float(), np.asarray(ref.astype(jnp.float32)), tol)


@pytest.mark.parametrize("c, dt, hw", MAIN_WIDTHS)
def test_k1_plain_matches_jax_kernel_at_main_widths(rng, c, dt, hw):
    x, p, prm = _main_width_block(rng, c, dt, hw)
    ref = jax_k1(x, p, interpret=True)
    with torch.no_grad():
        out = nafblock.k1_apply(_port(x), prm)
    err = _assert_close_in(out, ref, dt)
    if dt == "float32" and hw[1] > 2:
        assert_edges_like_interior(err)


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("c, dt, hw", MAIN_WIDTHS)
def test_k2_plain_matches_jax_kernel_at_main_widths(rng, c, dt, hw, spatial):
    x, p, prm = _main_width_block(rng, c, dt, hw)
    g = jnp.asarray(nhwc(rng, x.shape), dt)
    pooled = jnp.asarray(nhwc(rng, x.shape if spatial else (hw[0], 1, 1, c)), dt)
    ref = jax_k2(x, g, pooled, p, pooled_spatial=spatial, interpret=True)
    with torch.no_grad():
        out = nafblock.k2_apply(_port(x), _port(g), _port(pooled), prm)
    _assert_close_in(out, ref, dt)


def test_kernel_weights_are_prepared_once_per_version():
    """The bf16 forms' layouts: conv1's weight as it is and one float32
    array (taps transposed to (9, 2C)) for K1; the four 1x1 weights and one
    float32 array for K2. Kept while the params are unchanged, prepared anew
    after an in-place update and after a cast."""
    blk = NAFBlock(16)
    p = dict(blk.named_parameters())
    w1, vec = nafblock.k1_weights(p)
    assert tuple(w1.shape) == (32, 16) and w1.data_ptr() == p["conv1.weight"].data_ptr()
    taps = p["conv2.weight"].detach().reshape(32, 9).t().reshape(-1)
    assert vec.dtype == torch.float32 and vec.numel() == 24 * 16
    assert torch.equal(vec[:16], p["norm1.weight"].detach())
    assert torch.equal(vec[16:32], p["norm1.bias"].detach())
    assert torch.equal(vec[32:64], p["conv1.bias"].detach())
    assert torch.equal(vec[64:96], p["conv2.bias"].detach())
    assert torch.equal(vec[96:], taps)
    mats = nafblock.k2_weights(p)
    assert [tuple(m.shape) for m in mats[:4]] == [(16, 16), (16, 16), (32, 16), (16, 16)]
    assert mats[4].numel() == 9 * 16 and torch.equal(mats[4][32:48], p["beta"].detach().reshape(-1))
    assert all(a is b for a, b in zip(mats, nafblock.k2_weights(p)))   # kept
    with torch.no_grad():
        p["gamma"].add_(1.0)
    again = nafblock.k2_weights(p)
    assert torch.equal(again[4][128:], p["gamma"].detach().reshape(-1)) and again[4] is not mats[4]
    blk.to(torch.bfloat16)
    p = dict(blk.named_parameters())
    w1, vec = nafblock.k1_weights(p)
    assert w1.dtype == torch.bfloat16 and vec.dtype == torch.float32
    assert nafblock.k2_weights(p)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("c", nafblock.KERNEL_CHANNELS)
def test_design_names_the_form_by_dtype(c):
    """bfloat16 takes the bf16 forms at every width the kernels are built
    for, float32 the general forms; other widths and dtypes raise."""
    assert nafblock.design(c, torch.bfloat16) == {"k1": "bf16", "k2": "bf16"}
    assert nafblock.design(c, torch.float32) == {"k1": "general", "k2": "general"}
    with pytest.raises(ValueError, match="built for"):
        nafblock.design(c, torch.float16)
    with pytest.raises(ValueError, match="built for"):
        nafblock.design(2 * c + 8, torch.bfloat16)


@pytest.mark.parametrize("tlc", [None, 8])
def test_nafblock_fast_and_eager_match_flax(rng, tlc):
    x, jblk, p, blk = _block(rng, 8, 0.5, tlc)
    ref = jblk.apply({"params": p}, jnp.asarray(x))
    xt = torch.from_numpy(x)
    prm = dict(blk.named_parameters())
    with torch.no_grad():
        for out in (nafblock.nafblock_fast(xt, prm, tlc), nafblock.nafblock_eager(xt, prm, tlc),
                    blk(xt)):
            assert_edges_like_interior(assert_close(out, ref))
    # the eager block is JAX's nafblock_xla
    assert_close(nafblock.nafblock_eager(xt, prm, tlc).detach(),
                 jnaf.nafblock_xla(jnp.asarray(x), p, tlc))


def test_plain_versions_are_differentiable(rng):
    x, _, _, blk = _block(rng, 8, 0.5)
    xt = torch.from_numpy(x).requires_grad_()
    prm = dict(blk.named_parameters())
    nafblock.nafblock_fast(xt, prm, 8).square().sum().backward()
    assert xt.grad is not None and blk.conv1.weight.grad is not None


def test_kernel_wrappers_check_their_inputs(rng):
    _, _, _, blk = _block(rng, 8, 0.0)
    prm = dict(blk.named_parameters())
    with pytest.raises(ValueError, match="does not fit C=16"):
        nafblock.k1_apply(torch.zeros(1, 4, 4, 16), prm)
    with pytest.raises(ValueError, match="pooled"):
        nafblock.k2_apply(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8),
                          torch.zeros(1, 4, 1, 8), prm)
    with pytest.raises(KeyError, match="gamma"):
        nafblock.k2_apply(torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8),
                          torch.zeros(1, 1, 1, 8), {k: v for k, v in prm.items() if k != "gamma"})


# -- the network ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(jax model, shifted variables, the port's model with the same weights)."""
    jm = jax_build_model("nafnet_local", tlc_window=8, **TINY)
    v = random_variables(jm, seed=0)
    tm = build_model("nafnet_local", device="cpu", tlc_window=8, **TINY)
    tm.module.load_state_dict(jax_to_torch_state_dict("nafnet_local", flat_params(v)),
                              strict=True)
    return jm, v, tm


def test_nafnet_fast_apply_matches_jax(tiny):
    """fused_max_c=8: the C=8 blocks take the fused path, the C=16 and C=32
    blocks the eager one."""
    jm, v, tm = tiny
    x = np.random.default_rng(1).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    ref_fast = jax.jit(lambda vv, xx: jnaf.nafnet_fast_apply(
        vv, xx, tlc_window=8, fused_max_c=8, interpret=True, **TINY))(v, jnp.asarray(x))
    ref_fast = ref_fast["enhanced"]
    ref = jax.jit(lambda vv, xx: jm.apply(vv, {"image": xx}))(v, jnp.asarray(x))["enhanced"]
    with torch.no_grad():
        out = nafblock.nafnet_fast_apply(tm.module, torch.from_numpy(x),
                                         fused_max_c=8)["enhanced"]
        out_module = tm.apply({"image": torch.from_numpy(x)})["enhanced"]
    for o in (out, out_module):
        assert_close(o, ref_fast, TOL_MODEL)
        assert_close(o, ref, TOL_MODEL)


def test_apply_takes_the_module_forward_off_the_card(tiny, monkeypatch):
    """The fused path is for inference on a CUDA tensor only."""
    import dataclasses
    _, _, tm = tiny

    def boom(*args):
        raise AssertionError("fast path taken")

    model = dataclasses.replace(tm, fast_apply_fn=boom)
    x = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        ref = tm.module(x)["enhanced"]
        assert torch.equal(model.apply({"image": x})["enhanced"], ref)
        assert torch.equal(model.apply({"image": x}, training=True)["enhanced"], ref)


@pytest.fixture(scope="module")
def full_width_flat():
    """Zeros in the structure of the published NAFNet-SIDD width's params
    (``nafnet`` and ``nafnet_local`` have the same)."""
    jm = jax_build_model("nafnet_local")
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    return flat_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), v))


@pytest.mark.parametrize("name", ["nafnet", "nafnet_local"])
def test_bridge_loads_full_width_nafnet(full_width_flat, name):
    """The published width: every JAX param maps to a port param of the
    right shape (strict load), and the counts agree."""
    flat = full_width_flat
    tm = build_model(name, device="cpu")
    sd = jax_to_torch_state_dict(name, flat)
    tm.module.load_state_dict(sd, strict=True)
    assert tm.size_divisor == 16
    assert tm.param_count() == sum(a.size for a in flat.values()) == 29159715
    assert tuple(sd["ups.0.0.weight"].shape) == (1024, 512, 1, 1)
    assert tuple(sd["downs.0.weight"].shape) == (64, 32, 2, 2)
    assert tuple(sd["encoders.0.1.beta"].shape) == (1, 32, 1, 1)
    assert tuple(sd["middle_blks.11.sca.1.weight"].shape) == (512, 512, 1, 1)


def test_bridge_rejects_nafnet_faults():
    with pytest.raises(KeyError, match="matches no rule"):
        jax_to_torch_state_dict("nafnet_local", {"params/head/kernel": np.zeros((8, 8))})
    with pytest.raises(ValueError, match="beta"):
        jax_to_torch_state_dict("nafnet_local",
                                {"params/enc0_0/beta": np.zeros((1, 8), np.float32)})
    with pytest.raises(ValueError, match="LayerNorm"):
        jax_to_torch_state_dict("nafnet_local",
                                {"params/enc0_0/norm1/scale": np.zeros((1, 8), np.float32)})


def test_registry_names_match_jax():
    for name in ("nafnet", "nafnet_local", "NAFNet-Local"):
        assert name in enhax_torch.MODELS and name in enhax.MODELS
        assert enhax_torch.MODELS.canonical_name(name) == enhax.MODELS.canonical_name(name)
    assert (sorted(enhax_torch.MODELS.models_for_arch("nafnet"))
            == sorted(enhax.MODELS.models_for_arch("nafnet")) == ["nafnet", "nafnet_local"])
    assert build_model("nafnet", device="cpu", **TINY).size_divisor == 4


# -- entry points ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 24, 3), (2, 13, 21, 3)])
def test_predictor_matches_jax(tiny, rng, shape):
    """(13, 21) pads to (16, 24) and crops back."""
    jm, v, tm = tiny
    x = rng.uniform(0, 1, shape).astype(np.float32)
    ref = JaxPredictor(jm, variables=v).infer({"image": x})
    out = Predictor(tm, device="cpu").infer({"image": x})
    assert tuple(out["enhanced"].shape) == tuple(ref["enhanced"].shape)
    assert_close(out["enhanced"], ref["enhanced"], TOL_MODEL)


def test_predict_cli_on_nafnet_matches_jax(tmp_path, monkeypatch):
    """The CLI builds the registered model at its default width; a tiny
    NAFNet-TLC stands in for it here, in both packages."""
    from enhax.train.checkpoints import save_params_npz
    from enhax_torch.cli import predict as cli

    jm = jax_build_model("nafnet_local", tlc_window=8, **TINY)
    v = random_variables(jm, seed=3)
    weights = tmp_path / "w.npz"
    save_params_npz(weights, v)
    data = tmp_path / "imgs"
    data.mkdir()
    rng = np.random.default_rng(0)
    cv2.imwrite(str(data / "a.png"), (rng.uniform(0, 1, (13, 21, 3)) * 255).astype(np.uint8))
    real_build = build_model
    monkeypatch.setattr("enhax_torch.models.base.build_model",
                        lambda name, **kw: real_build(name, tlc_window=8, **TINY, **kw))
    cli.main(["--model", "nafnet_local", "--data", str(data), "--save-dir",
              str(tmp_path / "out"), "--weights", str(weights), "--device", "cpu"])
    ours = cv2.imread(str(tmp_path / "out" / "a.png")).astype(int)
    img = cv2.imread(str(data / "a.png"))[..., ::-1].astype(np.float32) / 255.0
    ref = JaxPredictor(jm, variables=v).infer({"image": img})["enhanced"][0]
    ref = np.clip(np.round(np.asarray(ref) * 255), 0, 255)[..., ::-1].astype(int)
    assert ours.shape == ref.shape == (13, 21, 3)
    assert np.abs(ours - ref).max() <= 1
