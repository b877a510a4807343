"""Port parity: Restormer against the JAX package, on the CPU in float32.

The fused RestormerBlock's plain path (``r1_plain`` -> ``mdta_attention`` ->
``r2_plain``, which the wrappers run on the CPU) against the Pallas kernels
in interpret mode, its tap-folded form (``dw_mxu=True``: ``r1_mxu_plain`` ->
``r2_mxu_plain``, the fold and the im2col helpers) against JAX's, R1's sums against numpy sums of the flax block's q and k,
the module and the fused network, the weight bridge and the registry. One
set of JAX weights goes through ``jax_to_torch_state_dict`` into the port;
temperature and the LayerNorms are drawn (at their init the softmax is
nearly flat and would hide a wrong normalisation). Tolerances: 2e-5 for a
block, 1e-5 * max(1, max|ref|) for R1's sums, 3e-5 for a network, 1e-6 for
the fold and the im2col; a bfloat16 block 2^-6 * max(1, max|ref|) (two bf16
steps: the frameworks round the same operands, but sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enhax
import enhax_torch
from enhax.kernels import restormer_block as jrb
from enhax.models.base import build_model as jax_build_model
from enhax.models.multitask.restormer import RestormerBlock as JaxBlock
from enhax.models.multitask.restormer import RestormerModule as JaxModule
from enhax.nn import layers as jl
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.kernels import restormer_block as rb
from enhax_torch.models.base import build_model
from enhax_torch.models.multitask.restormer import RestormerBlock
from torch_threads import capped_torch_threads  # noqa: F401

TOL_BLOCK = 2e-5
TOL_SUMS = 1e-5
TOL_MODEL = 3e-5
TINY = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "heads": (1, 1, 2, 2)}
jax_block_fast = jax.jit(jrb.restormer_block_fast,
                         static_argnames=("heads", "interpret", "dw_mxu"))


def flat_params(variables) -> dict:
    """The flat-key format of enhax.train.checkpoints.save_params_npz."""
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf)
    return flat


def drawn(variables, seed: int):
    """Values drawn by numpy in the variables' structure: temperature in
    [0.5, 3], LayerNorm scale 1 +- 0.3 and bias +- 0.2, kernels with
    variance 1/fan_in."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name == "temperature":
            v = rng.uniform(0.5, 3.0, a.shape)
        elif name == "scale":
            v = 1 + rng.uniform(-0.3, 0.3, a.shape)
        elif name == "bias":
            v = rng.uniform(-0.2, 0.2, a.shape)
        else:
            v = rng.normal(0, 1 / np.sqrt(np.prod(a.shape[:-1])), a.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, variables)


def assert_close(out, ref, tol, rel=False):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if rel else 1.0
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (err, tol * scale)


def port_block(jax_params, c: int, heads: int) -> RestormerBlock:
    """A port RestormerBlock holding the JAX block's params, through the bridge."""
    flat = {f"params/enc0_0/{k}": v for k, v in flat_params(jax_params).items()}
    sd = jax_to_torch_state_dict("restormer", flat)
    blk = RestormerBlock(c, heads)
    blk.load_state_dict({k.removeprefix("encoder_level1.0."): v for k, v in sd.items()})
    return blk


def block_case(heads, c, shape, seed=0):
    x = np.random.default_rng(seed).uniform(-1, 1, shape + (c,)).astype(np.float32)
    jblk = JaxBlock(c, heads)
    struct = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x))
    p = drawn(struct, seed + 1)["params"]
    return x, jblk, p, port_block(p, c, heads)


# (heads, C, (B, H, W)): one tile, a wide one, and a tall multi-tile image
BLOCKS = [(1, 16, (2, 16, 16)), (2, 16, (2, 24, 16)), (2, 16, (1, 64, 24))]
# the small Restormer's other (C, heads) pairs (dim 8, heads (1, 1, 2, 2)),
# whose kernels the narrow widths' instantiations run
NARROW = [(1, 8, (2, 16, 24)), (2, 32, (1, 16, 16)), (2, 64, (1, 8, 16))]


@pytest.mark.parametrize("heads, c, shape", BLOCKS + NARROW)
def test_block_fast_matches_jax_kernels(heads, c, shape):
    x, jblk, p, blk = block_case(heads, c, shape)
    ref = jax_block_fast(jnp.asarray(x), p, heads=heads, interpret=True, dw_mxu=False)
    prm = dict(blk.named_parameters())
    with torch.no_grad():
        out = rb.restormer_block_fast(torch.from_numpy(x), prm)
        assert_close(out, ref, TOL_BLOCK)
        # and the flax block, through the port's module forward
        assert_close(blk(torch.from_numpy(x)), jblk.apply({"params": p}, jnp.asarray(x)),
                     TOL_BLOCK)
    assert rb.r1_apply.launches == rb.r2_apply.launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("heads, c, shape", BLOCKS)
def test_block_fast_dw_mxu_matches_jax_kernels(heads, c, shape):
    """The tap-folded block (R1-mxu -> glue -> R2-mxu) against the JAX
    package's ``dw_mxu=True`` kernels in interpret mode."""
    x, _, p, blk = block_case(heads, c, shape, seed=3)
    ref = jax_block_fast(jnp.asarray(x), p, heads=heads, interpret=True, dw_mxu=True)
    with torch.no_grad():
        out = rb.restormer_block_fast(torch.from_numpy(x), dict(blk.named_parameters()),
                                      dw_mxu=True)
    assert_close(out, ref, TOL_BLOCK)
    assert rb.r1_mxu_apply.launches == rb.r2_mxu_apply.launches == 0


def test_block_fast_dw_mxu_matches_jax_in_bfloat16():
    """bf16 x and params: the fold is rounded to bf16 after the product in
    both packages, and the LN output before the product."""
    heads, c, shape = BLOCKS[1]
    x, _, p, blk = block_case(heads, c, shape, seed=4)
    pj = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
    ref = jax_block_fast(jnp.asarray(x, jnp.bfloat16), pj, heads=heads, interpret=True,
                         dw_mxu=True).astype(jnp.float32)
    prm = {k: v.detach().to(torch.bfloat16) for k, v in blk.named_parameters()}
    out = rb.restormer_block_fast(torch.from_numpy(x).to(torch.bfloat16), prm, dw_mxu=True)
    assert out.dtype == torch.bfloat16
    assert_close(out.float(), ref, 2.0 ** -6, rel=True)


def test_fold_and_im2col_match_jax():
    rng = np.random.default_rng(6)
    w_pt, dwk = rng.normal(size=(12, 20)), rng.normal(size=(3, 3, 20))
    t = rng.normal(size=(9, 7, 12))          # tile_h + 2 rows of a 7-wide strip
    w_pt, dwk, t = (a.astype(np.float32) for a in (w_pt, dwk, t))
    assert_close(rb.fold_dw_into_pointwise(torch.from_numpy(w_pt), torch.from_numpy(dwk)),
                 jrb._fold_dw_into_pointwise(jnp.asarray(w_pt), jnp.asarray(dwk)), 1e-6)
    assert_close(rb.dw9_inputs(torch.from_numpy(t)), jrb._dw9_inputs(jnp.asarray(t), 7), 1e-6)
    # and the identity they exist for: dw3x3(t @ W) on the 7 inner rows
    # equals dw9_inputs(t) @ fold(W, k), with SAME zero padding in W
    y = torch.from_numpy(t) @ torch.from_numpy(w_pt)
    ref = rb._dw3x3(y[None], torch.from_numpy(dwk).permute(2, 0, 1)[:, None])[0, 1:-1]
    out = rb.dw9_inputs(torch.from_numpy(t)) @ rb.fold_dw_into_pointwise(
        torch.from_numpy(w_pt), torch.from_numpy(dwk))
    assert_close(out, ref, 1e-4)


@pytest.mark.parametrize("heads, c, shape", BLOCKS[1:])
def test_r1_sums_match_flax_q_and_k(heads, c, shape):
    """gram, sum q^2 and sum k^2 against numpy sums of the flax block's q
    and k (after ``qkv_dw``), and v."""
    x, _, p, blk = block_case(heads, c, shape, seed=5)
    y = jl.LayerNorm2d(eps=1e-5).apply({"params": p["norm1"]}, jnp.asarray(x))
    qkv = jl.conv1x1(3 * c, use_bias=False).apply({"params": p["attn"]["qkv"]}, y)
    qkv = np.asarray(jl.DWConv3x3(3 * c, use_bias=False).apply(
        {"params": p["attn"]["qkv_dw"]}, qkv), np.float64)
    b, hd = shape[0], c // heads
    q, k, v = (t.reshape(b, -1, heads, hd) for t in np.split(qkv, 3, axis=-1))
    gram = np.einsum("bphc,bphd->bhcd", q, k).reshape(b, c, hd)
    with torch.no_grad():
        v_out, g_out, qss, kss = rb.r1_apply(torch.from_numpy(x), dict(blk.named_parameters()))
    assert_close(g_out, gram, TOL_SUMS, rel=True)
    assert_close(qss, (q * q).sum(1).reshape(b, 1, c), TOL_SUMS, rel=True)
    assert_close(kss, (k * k).sum(1).reshape(b, 1, c), TOL_SUMS, rel=True)
    assert_close(v_out, v.reshape(x.shape), TOL_SUMS, rel=True)
    assert g_out.dtype == qss.dtype == kss.dtype == torch.float32


def test_mdta_attention_is_the_normalised_softmax():
    """The glue equals the softmax of normalised q^T k times temperature."""
    rng = np.random.default_rng(2)
    q, k = rng.normal(size=(2, 30, 2, 8)), rng.normal(size=(2, 30, 2, 8))
    temp = rng.uniform(0.5, 2, (2, 1, 1))
    gram = torch.tensor(np.einsum("bphc,bphd->bhcd", q, k).reshape(2, 16, 8))
    qss = torch.tensor((q * q).sum(1).reshape(2, 1, 16))
    kss = torch.tensor((k * k).sum(1).reshape(2, 1, 16))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    kn = k / np.linalg.norm(k, axis=1, keepdims=True)
    logits = np.einsum("bphc,bphd->bhcd", qn, kn) * temp
    ref = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    out = rb.mdta_attention(gram, qss, kss, torch.tensor(temp))
    np.testing.assert_allclose(out.numpy(), ref.reshape(2, 16, 8), atol=1e-12)


def test_plain_path_is_differentiable():
    x, _, _, blk = block_case(1, 16, (1, 8, 8))
    xt = torch.from_numpy(x).requires_grad_()
    rb.restormer_block_fast(xt, dict(blk.named_parameters())).square().sum().backward()
    assert xt.grad is not None and blk.attn.qkv.weight.grad is not None


def test_wrappers_check_their_inputs():
    _, _, _, blk = block_case(1, 16, (1, 8, 8))
    prm = dict(blk.named_parameters())
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError, match="does not fit C=32"):
        rb.r1_apply(torch.zeros(1, 8, 8, 32), prm)
    with pytest.raises(KeyError, match="temperature"):
        rb.r1_apply(x, {k: v for k, v in prm.items() if k != "attn.temperature"})
    with pytest.raises(ValueError, match="attn"):
        rb.r2_apply(x, x, torch.zeros(1, 16, 5), prm)
    with pytest.raises(ValueError, match="v "):
        rb.r2_apply(x, torch.zeros(1, 8, 9, 16), torch.zeros(1, 16, 16), prm)


# -- the network ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(jax module, drawn variables, the port's model with the same weights)."""
    jm = JaxModule(**TINY)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    v = drawn(struct, seed=0)
    tm = build_model("restormer", device="cpu", **TINY)
    tm.module.load_state_dict(jax_to_torch_state_dict("restormer", flat_params(v)),
                              strict=True)
    return jm, v, tm


@pytest.mark.parametrize("fused_min_hw, hw", [(1, 32), (32, 64)])
def test_restormer_matches_jax(tiny, fused_min_hw, hw):
    """fused_min_hw=1 fuses every level; 32 at 64x64 fuses levels 0-1 and
    runs the module's block at 16x16 and 8x8."""
    jm, v, tm = tiny
    x = np.random.default_rng(hw).uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))["enhanced"]
    ref_fast = jax.jit(lambda vv, xx: jrb.restormer_fast_apply(
        vv, xx, fused_min_hw=fused_min_hw, interpret=True, **TINY))(v, jnp.asarray(x))
    with torch.no_grad():
        out = tm.module(torch.from_numpy(x))["enhanced"]
        fast = rb.restormer_fast_apply(tm.module, torch.from_numpy(x),
                                       fused_min_hw=fused_min_hw)["enhanced"]
    assert_close(out, ref, TOL_MODEL)
    assert_close(fast, ref_fast["enhanced"], TOL_MODEL)
    assert_close(fast, ref, TOL_MODEL)


def test_apply_takes_the_module_forward_off_the_card(tiny):
    import dataclasses
    _, _, tm = tiny

    def boom(*args):
        raise AssertionError("fast path taken")

    model = dataclasses.replace(tm, fast_apply_fn=boom)
    x = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        assert torch.equal(model.apply({"image": x})["enhanced"], tm.module(x)["enhanced"])


@pytest.fixture(scope="module")
def full_width_flat():
    """Zeros in the structure of the published Restormer's params."""
    jm = jax_build_model("restormer")
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    return flat_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), v))


def test_bridge_loads_full_width_restormer(full_width_flat):
    flat = full_width_flat
    tm = build_model("restormer", device="cpu")
    sd = jax_to_torch_state_dict("restormer", flat)
    tm.module.load_state_dict(sd, strict=True)
    assert tm.param_count() == sum(a.size for a in flat.values()) == 26126644
    assert tuple(sd["latent.7.attn.temperature"].shape) == (8, 1, 1)
    assert tuple(sd["encoder_level1.3.attn.qkv_dwconv.weight"].shape) == (144, 1, 3, 3)
    assert tuple(sd["decoder_level1.0.ffn.project_in.weight"].shape) == (510, 96, 1, 1)
    assert tuple(sd["refinement.3.norm2.body.weight"].shape) == (96,)
    assert tuple(sd["reduce_chan_level3.weight"].shape) == (192, 384, 1, 1)
    assert tuple(sd["up2_1.body.0.weight"].shape) == (192, 96, 3, 3)
    assert "reduce_chan_level1.weight" not in sd


def test_bridge_rejects_restormer_faults():
    tm = build_model("restormer", device="cpu", **TINY)
    jm = JaxModule(**TINY)
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    flat = flat_params(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), struct))
    missing = {k: a for k, a in flat.items() if not k.endswith("enc0_0/ffn/dwconv/kernel")}
    with pytest.raises(RuntimeError, match="Missing key"):
        tm.module.load_state_dict(jax_to_torch_state_dict("restormer", missing))
    with pytest.raises(ValueError, match="temperature"):
        jax_to_torch_state_dict("restormer", {"params/enc0_0/attn/temperature":
                                              np.ones((1, 1), np.float32)})
    bad = dict(flat, **{"params/enc0_0/attn/qkv/kernel": np.zeros((8, 16), np.float32)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        tm.module.load_state_dict(jax_to_torch_state_dict("restormer", bad))
    with pytest.raises(KeyError, match="matches no rule"):
        jax_to_torch_state_dict("restormer", {"params/head/kernel": np.zeros((8, 8))})


def test_registry_names_match_jax():
    assert "restormer" in enhax_torch.MODELS and "restormer" in enhax.MODELS
    assert (sorted(enhax_torch.MODELS.models_for_arch("restormer"))
            == sorted(enhax.MODELS.models_for_arch("restormer")) == ["restormer"])
    jm, tm = jax_build_model("restormer"), build_model("restormer", device="cpu", **TINY)
    assert tm.size_divisor == jm.size_divisor == 8
    assert set(tm.tasks) == {str(t) for t in jm.tasks}


# R1's grid: (images, heads, chunk H, W) of the five levels on the tiled path
# (8 tiles of 384x384) and ragged shapes, at the residencies of one, two and
# three blocks an SM of the 132-SM card, and small ones
R1_GRID_SHAPES = [(8, 1, 384, 384), (8, 1, 384, 384), (8, 2, 192, 192), (8, 4, 96, 96),
                  (8, 8, 48, 48), (1, 1, 37, 53), (2, 8, 19, 29), (6, 1, 384, 384),
                  (1, 1, 1, 37), (100, 8, 48, 48)]


@pytest.mark.parametrize("resident", [132, 264, 396, 7])
@pytest.mark.parametrize("tile", [(8, 16), (8, 8), (4, 8)])
def test_r1_grid_fills_one_wave(resident, tile):
    for b, heads, h, w in R1_GRID_SHAPES:
        tiles = rb.r1_tiles(h, w, tile)
        assert tiles == -(-h // tile[0]) * -(-w // tile[1])
        splits = rb.r1_grid(resident, b, heads, tiles)
        assert 1 <= splits <= tiles
        blocks = splits * b * heads
        if b * heads <= resident:
            # one wave, and no split could be added without a second one
            assert blocks <= resident
            assert splits == tiles or blocks + b * heads > resident
        else:
            assert splits == 1   # each (image, head) needs a block of its own


def test_r1_grid_at_dec0_is_one_wave_of_128_blocks():
    # 8 images x 1 head on 132 resident blocks: 16 splits (the rounded-up
    # choice, 17, gave 136 blocks: 4 in a second wave)
    assert rb.r1_grid(132, 8, 1, rb.r1_tiles(384, 384, (8, 16))) == 16


def test_prepared_weights_follow_in_place_updates():
    blk = RestormerBlock(48, 1)
    p = dict(blk.named_parameters())
    first = rb.r2_weights(p, False)
    assert all(a is b for a, b in zip(first, rb.r2_weights(p, False)))   # kept
    with torch.no_grad():
        p["ffn.project_in.weight"].mul_(2.0)
    second = rb.r2_weights(p, False)
    assert torch.allclose(second[3], 2 * first[3]) and second[3] is not first[3]
    # load_state_dict copies in place; module.to gives new storage
    state = {k: torch.zeros_like(v) for k, v in blk.state_dict().items()}
    blk.load_state_dict(state)
    assert rb.r1_weights(p, False)[2].abs().max().item() == 0.0
    blk.to(torch.bfloat16)
    p = dict(blk.named_parameters())
    w = rb.r1_weights(p, True)
    assert w[2].dtype == torch.bfloat16 and w[3].dtype == torch.float32


def test_prepared_weights_match_the_layout():
    blk = RestormerBlock(48, 1)   # hidden 127: padded to 128
    p = dict(blk.named_parameters())
    wp, lnw, lnb, w_in, dw, w_out = rb.r2_weights(p, False)
    hidden, hp = 127, 128
    src = p["ffn.project_in.weight"].detach().reshape(2 * hidden, 48)
    # chunk 0: rows 0..31 are a_0..a_31, rows 32..63 b_0..b_31
    assert torch.equal(w_in[:32], src[:32]) and torch.equal(w_in[32:64], src[hidden:hidden + 32])
    # the last chunk: a_96..a_126, a zero row, b_96..b_126, a zero row
    assert torch.equal(w_in[192:223], src[96:hidden]) and w_in[223].abs().max() == 0
    assert torch.equal(w_in[224:255], src[hidden + 96:]) and w_in[255].abs().max() == 0
    assert tuple(dw.shape) == (2 * hp, 9) and tuple(w_out.shape) == (48, hp)
    assert w_out[:, hidden:].abs().max() == 0


@pytest.mark.parametrize("c, heads", rb.KERNEL_WIDTHS)
def test_r1_mxu_weights_match_the_jax_fold(c, heads):
    """R1-mxu's prepared weights read back from their layout: the JAX
    package's fold of the same weights (``_fold_dw_into_pointwise`` in
    float32, then cast to the params' dtype), bit for bit; in bf16 the bf16
    form's (heads, 3, hd, 9C) rows, in float32 the general form's (3C, 9C)."""
    _, _, p, blk = block_case(heads, c, (1, 8, 8), seed=7)
    hd = c // heads
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        w = jnp.asarray(p["attn"]["qkv"]["kernel"]).astype(jdt).astype(jnp.float32)
        dwk = jnp.asarray(p["attn"]["qkv_dw"]["kernel"]).astype(jdt).astype(jnp.float32)
        ref = np.asarray(jrb._fold_dw_into_pointwise(w, dwk.reshape(3, 3, 3 * c))
                         .astype(jdt).astype(jnp.float32))
        prm = {k: t.detach().to(dtype) for k, t in blk.named_parameters()}
        lnw, lnb, wf = rb.r1_mxu_weights(prm, dtype == torch.bfloat16)
        assert wf.dtype == lnw.dtype == lnb.dtype == dtype and wf.is_contiguous()
        assert torch.equal(lnw.reshape(c), prm["norm1.body.weight"])
        assert torch.equal(lnb.reshape(c), prm["norm1.body.bias"])
        if dtype == torch.bfloat16:   # (heads, q/k/v, hd, 9C) -> (3C, 9C)
            assert tuple(wf.shape) == (3 * c, 9 * c)
            wf = wf.reshape(heads, 3, hd, 9 * c).transpose(0, 1).reshape(3 * c, 9 * c)
        np.testing.assert_array_equal(wf.t().float().numpy(), ref)


@pytest.mark.parametrize("c, heads", rb.KERNEL_WIDTHS)
def test_r2_mxu_weights_match_the_jax_fold(c, heads):
    """R2-mxu's prepared weights read back from their chunk order: the
    JAX package's fold of project_in and its taps, bit for bit, in bf16 and
    in float32; the hidden width padded to hp with zero rows and columns."""
    _, _, p, blk = block_case(heads, c, (1, 8, 8), seed=8)
    hidden = p["ffn"]["project_out"]["kernel"].shape[0]
    hp = rb.hidden_padded(hidden)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        w = jnp.asarray(p["ffn"]["project_in"]["kernel"]).astype(jdt).astype(jnp.float32)
        dwk = jnp.asarray(p["ffn"]["dwconv"]["kernel"]).astype(jdt).astype(jnp.float32)
        ref = np.asarray(jrb._fold_dw_into_pointwise(w, dwk.reshape(3, 3, 2 * hidden))
                         .astype(jdt).astype(jnp.float32))
        prm = {k: t.detach().to(dtype) for k, t in blk.named_parameters()}
        wp, lnw, lnb, w_in, w_out = rb.r2_mxu_weights(prm, dtype == torch.bfloat16)
        assert all(t.dtype == dtype and t.is_contiguous() for t in (wp, lnw, lnb, w_in, w_out))
        assert tuple(w_in.shape) == (2 * hp, 9 * c) and tuple(w_out.shape) == (c, hp)
        # chunk j's 64 rows are a_32j.. then b_32j..: back to (a | b) over hp each
        ab = w_in.reshape(hp // rb.HIDDEN_CHUNK, 2, rb.HIDDEN_CHUNK, 9 * c).transpose(0, 1)
        ab = ab.reshape(2, hp, 9 * c)
        assert ab[:, hidden:].abs().sum().item() == 0
        folded = torch.cat([ab[0, :hidden], ab[1, :hidden]]).t()
        np.testing.assert_array_equal(folded.float().numpy(), ref)
        assert torch.equal(w_out[:, :hidden], prm["ffn.project_out.weight"].reshape(c, hidden))
        assert w_out[:, hidden:].abs().sum().item() == 0
        assert torch.equal(wp, prm["attn.project_out.weight"].reshape(c, c))


# -- the widths the kernels are built for, against every Restormer and NAFNet
# the repo builds ---------------------------------------------------------------

def _repo_model_cfgs(arch: str) -> dict:
    """Every configuration of ``arch`` the repo builds: the registered
    default, the shipped config, the zoo's entries and the quality chain's
    small model (``run/make_quality.py``)."""
    import sys
    from pathlib import Path

    from enhax.zoo import ZOO
    from enhax_torch.utils.config import load_config
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo / "run"))
    try:
        from make_quality import MODELS_UNDER_TEST
    finally:
        sys.path.pop(0)
    config = {"restormer": "restormer_rain13k.py", "nafnet": "nafnet_sidd.py"}[arch]
    cfgs = {"default": {}, config: load_config(str(repo / "configs" / config))["model_cfg"]}
    cfgs.update({f"zoo:{k}": e.build_kwargs for k, e in ZOO[arch].items()})
    cfgs.update({name: cfg for name, model, cfg, *_ in MODELS_UNDER_TEST if model == arch})
    return cfgs


def _blocks(arch: str, cfg: dict, cls) -> list:
    from enhax_torch.constants import MODELS
    with torch.device("meta"):   # the structure only
        return [m for m in MODELS.build(arch, **cfg).module.modules() if isinstance(m, cls)]


def test_fused_widths_cover_every_restormer_the_repo_builds():
    """Every (C, heads) of a RestormerBlock in a Restormer the repo builds
    has its R1/R2 instantiation: on the card such a block runs the kernels,
    and a pair outside ``KERNEL_WIDTHS`` raises there (no fallback).
    ``restormer_tiny`` (dim 8, heads (1, 1, 2, 2)) adds (8, 1), (16, 1),
    (32, 2) and (64, 2) to the published five."""
    cfgs = _repo_model_cfgs("restormer")
    assert "restormer_tiny" in cfgs
    for name, cfg in cfgs.items():
        widths = {(b.norm1.body.weight.shape[0], b.attn.num_heads)
                  for b in _blocks("restormer", cfg, RestormerBlock)}
        missing = widths - set(rb.KERNEL_WIDTHS)
        assert not missing, (name, sorted(missing))


def test_fused_channels_cover_every_nafnet_the_repo_builds():
    """Every NAFBlock width up to the fused path's C <= 64 in a NAFNet the
    repo builds (``nafnet_tiny``'s 8, 16, 32; the shipped widths 32 and 64)
    has its K1/K2 instantiation."""
    from enhax_torch.kernels import nafblock
    from enhax_torch.models.multitask.nafnet import NAFBlock
    for name, cfg in _repo_model_cfgs("nafnet").items():
        widths = {b.conv1.in_channels for b in _blocks("nafnet", cfg, NAFBlock)}
        missing = {c for c in widths if c <= 64} - set(nafblock.KERNEL_CHANNELS)
        assert not missing, (name, sorted(missing))
