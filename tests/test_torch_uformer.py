"""Port parity: Uformer against the JAX package, on the CPU.

Every registered name (``uformer_re``/``uformer``, ``uformer_t``, ``_s``,
``_b``, ``_noshift``, ``_fastleff``) built by each package's
``_make_uformer`` with its own shift and modulator flags at a small size
(dim 8, one block a stage but two in the outer encoder and decoder stages,
so each has a shifted block), on 1x128x128 (the divisor 128). One set of
weights drawn with numpy goes through the weight bridge into the port. Per
name: the forward and the Charbonnier loss in float32; every gradient of
the loss in float64 (both packages; the logits stay float32 in both, as
the JAX layer asks) for one name of each flag combination (``uformer_t``,
``_s`` and ``_fastleff`` build ``uformer_b``'s graph at this size); the forward of the bf16 model on bf16 weights against
JAX's bf16. In float32 the gradients agree within 1e-5 x max(1, max|ref|)
but for the output conv's bias, a sum over 3 x 16,384 per-pixel terms that
the two packages take in other orders (2.2e-5 apart at a value of 0.31);
in float64 every gradient agrees within 4e-8. The three flag combinations
(shift and modulator, shift alone, modulator alone) compile once each on
the JAX side. bf16: a LeWin block on bf16 weights against JAX's bf16 block,
and the small ``uformer_b`` against JAX's bf16 model. Single LeWin
blocks: shifted and not, with the modulator, and one whose window shrinks
to a map smaller than it (built for it with ``input_resolution``); the
shift mask and the bias index against the JAX package's. The bridge loads
the full-width ``uformer_b`` strictly, with the reference's
``relative_position_index`` buffers in the state dict.

Tolerances: float32 outputs, losses and gradients 1e-5 x max(1, max|ref|)
(per tensor for the gradients); a bf16 block 2^-6 x max(1, max|ref|), the
bf16 tolerance of the Restormer tests (each package rounds every op's
output to bfloat16 in its own order: JAX's depthwise conv sums its nine
taps in bf16, torch's once); the bf16 network as the HINet tests hold it,
3e-2 x max(1, max|ref|) and a mean gap within twice the JAX package's own
bf16-against-float32 mean gap (through 16 blocks the rounding grows: JAX's
bf16 output is 2.1% of max|ref| from its float32 output, the port's bf16
as far from JAX's bf16).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.multitask import uformer as juf
from enhax.nn import layers as jl
from enhax_torch.constants import MODELS
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.multitask import uformer as uf
from enhax_torch.nn import layers as tl
from torch_train_parity import draw_like, flat_params
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_BF16 = 2.0 ** -6
TOL_BF16_NET = 3e-2
# (name, use_shift, modulator) as the registry builds each
NAMES = [("uformer_re", True, False), ("uformer_t", True, True), ("uformer_s", True, True),
         ("uformer_b", True, True), ("uformer_noshift", False, True),
         ("uformer_fastleff", True, True)]
# one name of each (shift, modulator) combination
GRAD_NAMES = ("uformer_re", "uformer_b", "uformer_noshift")
DEPTHS = (2, 1, 1, 1, 1, 1, 1, 1, 2)
DIM = 8


def close(out, ref, tol, what=""):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), (what, err)


_JITTED = {}


def jax_loss(jm, flags, x64=False):
    """JAX's (loss, enhanced) of ``jm`` and its gradient, jitted once per
    flag combination (the small variants share their structure)."""
    key = (flags, x64)
    if key not in _JITTED:
        def fn(p, b):
            loss, outputs = jm.forward_loss(p, b)
            return loss, outputs["enhanced"]
        _JITTED[key] = jax.jit(jax.value_and_grad(fn, has_aux=True) if x64 else fn)
    return _JITTED[key]


@pytest.fixture(scope="module")
def pairs():
    """Each name's JAX model and variables and the port's model holding them,
    and one batch (built once: the JAX side's tracing dominates)."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    img = np.clip(ref + rng.normal(0, 0.1, ref.shape), 0, 1).astype(np.float32)
    batch = {"image": img, "ref_image": ref}
    out = {}
    for i, (name, shift, mod) in enumerate(NAMES):
        jm = juf._make_uformer(name, DIM, DEPTHS, use_shift=shift, modulator=mod)
        struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0), {"image": jnp.asarray(img)})
        v = draw_like(struct, np.random.default_rng(10 + i))
        tm = uf._make_uformer(name, DIM, DEPTHS, use_shift=shift, modulator=mod)
        tm.module.load_state_dict(jax_to_torch_state_dict(name, flat_params(v)))
        out[name] = (jm, v, tm)
    return out, batch


@pytest.mark.parametrize("name", [n for n, _, _ in NAMES])
def test_forward_loss_and_gradients_match_jax(pairs, name):
    models, batch = pairs
    jm, v, tm = models[name]
    flags = dict((n, (s, m)) for n, s, m in NAMES)[name]
    loss_ref, out_ref = jax_loss(jm, flags)(v, {k: jnp.asarray(a) for k, a in batch.items()})
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    with torch.no_grad():
        loss, outputs = tm.forward_loss(tb)
    close(outputs["enhanced"], out_ref, TOL, "enhanced")
    close(loss, loss_ref, TOL, "loss")
    # modulators exactly where the registry puts them: decoders only
    mods = [k for k, _ in tm.module.named_parameters() if "modulator" in k]
    assert all(k.startswith("decoderlayer_") for k in mods)
    assert bool(mods) == flags[1]
    if name not in GRAD_NAMES:
        return
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), v)
        b64 = {k: jnp.asarray(a, jnp.float64) for k, a in batch.items()}
        _, grads = jax_loss(jm, flags, x64=True)(v64, b64)
        grads = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(a)
                 for kp, a in jax.tree_util.tree_flatten_with_path(grads)[0]}
    grads_ref = jax_to_torch_state_dict(name, grads)
    m64 = copy.deepcopy(tm.module).double()
    loss64 = tm.loss_fn(m64(tb["image"].double()), {k: t.double() for k, t in tb.items()})
    loss64.backward()
    for k, p in m64.named_parameters():
        close(p.grad, grads_ref[k].numpy(), TOL, k)


def test_bf16_forward_matches_jax_bf16(pairs):
    models, batch = pairs
    jm, v, tm = models["uformer_b"]
    vb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), v)
    ref = jax.jit(jm.apply)(vb, {"image": jnp.asarray(batch["image"], jnp.bfloat16)})["enhanced"]
    ref = np.asarray(ref.astype(jnp.float32))
    ref32 = np.asarray(jax_loss(jm, (True, True))(
        v, {k: jnp.asarray(a) for k, a in batch.items()})[1])
    m16 = copy.deepcopy(tm.module).to(torch.bfloat16)
    with torch.no_grad():
        out = m16(torch.from_numpy(batch["image"]).to(torch.bfloat16))["enhanced"]
    assert out.dtype == torch.bfloat16
    close(out, ref, TOL_BF16_NET, "bf16")
    gap = np.abs(out.float().numpy() - ref).mean()
    assert gap <= 2 * np.abs(ref - ref32).mean(), gap


@pytest.mark.parametrize("shift, mod", [(0, False), (4, True)])
def test_bf16_block_matches_jax_bf16(shift, mod):
    dim, heads, ws = 16, 2, 8
    x = np.random.default_rng(6).uniform(-1, 1, (2, 16, 24, dim)).astype(np.float32)
    jb = juf.LeWinBlock(dim, heads, ws, shift=shift, use_modulator=mod)
    v = draw_like(jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                  np.random.default_rng(7))
    vb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), v)
    ref = jb.apply(vb, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32)
    blk = port_block(v, shift, mod).to(torch.bfloat16)
    with torch.no_grad():
        close(blk(torch.from_numpy(x).to(torch.bfloat16)), ref, TOL_BF16)


def lone_block(shift, mod, hw, seed, input_resolution=None):
    """A JAX LeWinBlock's output on a (2, h, w, 16) map and the port block
    holding its weights."""
    dim, heads, ws = 16, 2, 8
    x = np.random.default_rng(seed).uniform(-1, 1, (2,) + hw + (dim,)).astype(np.float32)
    jb = juf.LeWinBlock(dim, heads, ws, shift=shift, use_modulator=mod)
    struct = jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x))
    v = draw_like(struct, np.random.default_rng(seed + 1))
    return x, jb.apply(v, jnp.asarray(x)), port_block(v, shift, mod, input_resolution)


def port_block(v, shift, mod, input_resolution=None):
    """A port LeWinBlock (16 channels, 2 heads) holding a JAX block's
    variables ``v``, through the bridge."""
    flat = {f"params/enc0_0/{k.removeprefix('params/')}": a for k, a in flat_params(v).items()}
    sd = jax_to_torch_state_dict("uformer_re", flat)
    blk = uf.LeWinBlock(16, 2, 8, shift=shift, use_modulator=mod,
                        input_resolution=input_resolution)
    blk.load_state_dict({k.removeprefix("encoderlayer_0.blocks.0."): t for k, t in sd.items()})
    return blk


@pytest.mark.parametrize("shift, mod", [(0, False), (4, False), (4, True)])
def test_lewin_block_matches_jax(shift, mod):
    x, ref, blk = lone_block(shift, mod, (16, 24), seed=3)
    with torch.no_grad():
        close(blk(torch.from_numpy(x)), ref, TOL)


@pytest.mark.parametrize("hw", [(4, 4), (8, 8), (4, 8)])
def test_lewin_block_whose_window_shrinks(hw):
    """At min(H, W) <= 8 the JAX block drops the shift and takes a window of
    min(H, W), its bias table and modulator sized for it; the port's block,
    built for that resolution, holds the same weights and output; built for
    the full window it refuses the map."""
    x, ref, blk = lone_block(4, True, hw, seed=5, input_resolution=hw)
    assert blk.window_size == min(hw) and blk.shift == 0
    with torch.no_grad():
        close(blk(torch.from_numpy(x)), ref, TOL)
    if min(hw) < 8:
        with pytest.raises(ValueError, match="input_resolution"):
            uf.LeWinBlock(16, 2, 8, shift=4)(torch.from_numpy(x))


@pytest.mark.parametrize("h, w, ws, shift", [(16, 16, 8, 4), (16, 24, 8, 4), (8, 16, 4, 2)])
def test_shift_mask_and_bias_index_match_jax(h, w, ws, shift):
    np.testing.assert_array_equal(tl.make_shift_attn_mask(h, w, ws, shift).numpy(),
                                  np.asarray(jl.make_shift_attn_mask(h, w, ws, shift)))
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    diff = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    np.testing.assert_array_equal(tl.relative_position_index(ws).numpy(),
                                  diff[0] * (2 * ws - 1) + diff[1])


def test_bridge_loads_full_width_uformer_b_and_the_reference_buffers():
    """The published Uformer-B (dim 32, depths (1,2,8,8,2,8,8,2,1), 50.9M
    params): JAX's params bridge strictly; a state dict with the
    reference's ``relative_position_index`` buffers loads too."""
    jm = juf.uformer_b()
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 128, 128, 3), jnp.float32)})
    flat = {k: np.zeros(s.shape, np.float32) for k, s in flat_params(
        jax.tree_util.tree_map(lambda s: np.zeros((), np.float32), struct)).items()}
    shapes = {"/".join(str(getattr(k, "key", k)) for k in kp): s.shape
              for kp, s in jax.tree_util.tree_flatten_with_path(struct)[0]}
    flat = {k: np.full(shapes[k], 0.5, np.float32) for k in flat}
    sd = jax_to_torch_state_dict("uformer_b", flat)
    with torch.device("meta"):   # no weights drawn: all are loaded below
        tm = MODELS.build("uformer_b")
    tm.module.to_empty(device="cpu")
    assert tm.param_count() == sum(int(np.prod(s)) for s in shapes.values()) == 50_880_946
    released = dict(sd)
    for name, m in tm.module.named_modules():
        if isinstance(m, tl.WindowAttention):
            released[f"{name}.relative_position_index"] = m.relative_position_index.clone()
    tm.module.load_state_dict(released)
    assert all(bool((p == 0.5).all()) for p in tm.module.parameters())


def test_registry_names_and_divisor():
    for name, shift, mod in NAMES + [("uformer", True, False)]:
        with torch.device("meta"):   # the structure only: no weights drawn
            m = MODELS.build(name)
        assert m.size_divisor == 128 and m.arch == "uformer"
        blocks = [b for b in m.module.modules() if isinstance(b, uf.LeWinBlock)]
        assert any(b.shift for b in blocks) == shift
        assert any(b.modulator is not None for b in blocks) == mod
