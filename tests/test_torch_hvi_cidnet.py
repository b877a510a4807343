"""Port parity on the CPU: HVI-CIDNet (``hvi_cidnet_re``, ``hvi_cidnet``)
against the JAX package at a narrow width (channels (8, 8, 16, 16), heads
(1, 2, 4, 8): every level, head count and block kept) on 32x32.

The training forward (RGB and HVI outputs) and ``cidnet_loss`` (L1, SSIM,
edge and perceptual terms on RGB and on HVI) against the JAX package
(``check_forward_loss_grads``: at this narrow width on random weights both
packages' float32 outputs are 1e-5-5e-5 from float64, so the forward is
held to the float64 witness within 4x the JAX package's own float32 gap),
every gradient within 1e-4 x max|ref| in float64; ``CrossCAB`` alone, in float32 and, its logits in float32
before the softmax, in bf16 against the JAX package's bf16 (2^-6 x max(1,
max|ref|)); the bf16 ``Predictor`` at the published width against the
JAX package's bf16 with its align-corners resize grid in float32; the
reference names through the JAX package's own loader;
``configs/hvi_cidnet_re_lol_v1.py`` (the gradual warm-up into cosine
restarts) through both train CLIs for 2 steps in float64 (the loss and
every parameter within 1e-5 x max(1, max|ref|)); the registry entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import hvi_cidnet as jcid
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import hvi_cidnet as cid
from test_torch_lllinet import supervised_dp
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import (assert_close, flat_params,  # noqa: F401
                                   pairs, shared_pair)
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"channels": (8, 8, 16, 16), "heads": (1, 2, 4, 8)}


def test_forward_loss_and_gradients_match_jax(pairs):
    dp = supervised_dp(seed=2)
    jm, v, tm = shared_pair(pairs, "hvi_cidnet_re", dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim, heads", [(8, 2), (16, 8)])
def test_cross_attention_matches_jax(dim, heads, dtype):
    rng = np.random.default_rng(3)
    x, y = (rng.normal(0, 1, (2, 8, 12, dim)).astype(np.float32) for _ in range(2))
    jmod = jcid.CrossCAB(dim, heads)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.5, a.shape), jnp.float32), v)
    tmod = cid.CrossCAB(dim, heads)
    sd = jax_to_torch_state_dict("hvi_cidnet_re", {
        "params/i_lca1/ffn/" + k.split("/", 1)[1]: a for k, a in flat_params(v).items()})
    tmod.load_state_dict({k[len("i_lca1.ffn."):]: t for k, t in sd.items()})
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    ref = jmod.apply(jax.tree_util.tree_map(lambda a: a.astype(jd), v),
                     jnp.asarray(x, jd), jnp.asarray(y, jd))
    out = tmod.to(td)(*(torch.from_numpy(a).to(td).permute(0, 3, 1, 2) for a in (x, y)))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    assert_close(out.float().permute(0, 2, 3, 1), np.asarray(ref, np.float32), tol)


def test_bf16_serving_no_further_from_float32_than_jax(capsys, monkeypatch):
    """At the published width on 1x128x128, through both packages'
    ``Predictor``s on the JAX init: the port's bf16 serving is 0.149 (max) /
    0.0075 (mean) from its float32 serving and the JAX package's own bf16
    1.0 / 0.117 from its float32. The JAX package's ``resize_align_corners``
    builds its sampling grid in the input's dtype, so in bf16 its halvings
    and resizes sample at positions rounded to 8 bits; torch's bilinear
    keeps them in float32, as the reference's ``nn.UpsamplingBilinear2d``
    does. With that grid in float32 (the witness only), the JAX package's
    bf16 is 0.126 / 0.0076 from its float32, and the port's bf16 is held to
    it: the mean |d| within twice that own mean gap, the max within
    chip_smoke.py's 0.3, x max(1, max|ref|). Also the port's mean gap under
    the JAX package's, its float32 within 1e-3 of JAX's float32 (the net's
    float32 conditioning at this width, as the narrow one's above)."""
    import importlib

    from enhax.infer import Predictor as JaxPredictor
    from enhax_torch.infer import Predictor
    from torch_instance_parity import pair
    jax_resize = importlib.import_module("enhax.ops.resize").resize_align_corners

    def resize_on_a_float32_grid(image, size):
        image = jnp.asarray(image)
        return jax_resize(image.astype(jnp.float32), size).astype(image.dtype)

    x = np.random.default_rng(15).uniform(0, 0.4, (1, 128, 128, 3)).astype(np.float32)
    jm, v, tm = pair("hvi_cidnet_re", {"image": x})

    def serve(pkg, bf16):
        pred = (JaxPredictor(jm, variables=v, bf16=bf16) if pkg != "port"
                else Predictor(tm, device="cpu", bf16=bf16))
        return np.asarray(pred({"image": x})["enhanced"], np.float32)

    outs = {(pkg, bf16): serve(pkg, bf16) for pkg in ("jax", "port") for bf16 in (False, True)}
    monkeypatch.setattr(jcid, "resize_align_corners", resize_on_a_float32_grid)
    outs["jax_float32_grid", True] = serve("jax_float32_grid", True)
    gap = {pkg: np.abs(outs[pkg, True] - outs[pkg, False]) for pkg in ("jax", "port")}
    gap["jax_float32_grid"] = np.abs(outs["jax_float32_grid", True] - outs["jax", False])
    d = np.abs(outs["port", True] - outs["jax_float32_grid", True])
    with capsys.disabled():
        print(f"\nhvi_cidnet_re 1x128x128 bf16 vs float32 (max / mean): port "
              f"{gap['port'].max():.4g} / {gap['port'].mean():.4g}; jax {gap['jax'].max():.4g} / "
              f"{gap['jax'].mean():.4g}; jax on a float32 grid {gap['jax_float32_grid'].max():.4g}"
              f" / {gap['jax_float32_grid'].mean():.4g}; port bf16 vs that {d.max():.4g} / "
              f"{d.mean():.4g}")
    scale = max(1.0, float(np.abs(outs["jax", False]).max()))
    assert d.mean() <= 2 * gap["jax_float32_grid"].mean() * scale
    assert d.max() <= 0.3 * scale
    assert gap["port"].mean() <= gap["jax"].mean()
    assert_close(outs["port", False], outs["jax", False], 1e-3)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = shared_pair(pairs, "hvi_cidnet_re", supervised_dp(seed=2), **SMALL)
    check_round_trip(tm, v, mappings.hvi_cidnet_name_map())
    keys = set(tm.module.state_dict())
    for k in ("trans.density_k", "hve_block0.1.weight", "ie_block1.down.0.weight",
              "hvd_block3.up_scale.0.weight", "hvd_block3.up.weight",
              "i_lca1.ffn.q_dwconv.weight", "i_lca1.ffn.kv_dwconv.weight",
              "ie_block1.prelu.weight", "i_lca1.ffn.temperature", "i_lca1.norm.weight"):
        assert k in keys, k


def test_config_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"lol_v1/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.3)), ("ref", (0.2, 1.0)))})
    tiny_config("configs/hvi_cidnet_re_lol_v1.py", tmp_path / "tiny.py", SMALL)
    # in float64: in float32 a fifth of the narrow net's weights have
    # gradients within rounding of 0 (the JAX package's own float32 output
    # is 5e-5 from its float64), so Adam's first steps (+-lr each) take their
    # signs from the rounding; in float64 every parameter is held at 1e-5
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     supervised_dp(), x64=True)
    assert name == "hvi_cidnet_re"
    assert_clis_agree(jrun, prun, name)


@pytest.mark.parametrize("name", ["hvi_cidnet_re", "hvi_cidnet"])
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    assert tm.name == jm.name == "hvi_cidnet_re"
    for attr in ("arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 32, 32, 3), jnp.float32)})
    assert tm.param_count() == sum(int(np.prod(a.shape))
                                   for a in jax.tree_util.tree_leaves(struct))
