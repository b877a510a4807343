"""Port parity on the CPU: LYT-Net (``lyt_net_re``, ``lyt_net``) against the
JAX package at a narrow width (filters 8: denoisers of 4 channels, MHSA of 4
heads) on 64x64 (the divisor: a pool of 8 after three stride-2 convs).

The training forward and ``lyt_loss`` (smooth L1, perceptual, histogram,
MS-SSIM, PSNR and colour terms) within 1e-5 x max(1, max|ref|) of the JAX
package in float64, every gradient within 1e-4 x max|ref|; ``MHSA`` alone
with its tokens taken from the NCHW tensor's memory as the reference takes
them, on a non-square map; the half-pixel nearest upsample on sizes that
are not multiples; the reference names through the JAX package's own
loader; ``configs/lyt_net_re_lol_v1.py`` through both train CLIs for 2
steps; the registry entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie import lyt_net as jlyt
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import lyt_net as lyt
from test_torch_lllinet import supervised_dp
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import (assert_close, flat_params,  # noqa: F401
                                   pairs, shared_pair)
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"filters": 8}


def test_forward_loss_and_gradients_match_jax(pairs):
    dp = supervised_dp(hw=64, seed=4)
    jm, v, tm = shared_pair(pairs, "lyt_net_re", dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


@pytest.mark.parametrize("h, w", [(6, 10), (8, 8)])
def test_mhsa_tokens_as_the_reference_takes_them(h, w):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, h, w, 8)).astype(np.float32)
    jmod = jlyt.MHSA(8, 4)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    sd = jax_to_torch_state_dict("lyt_net_re", {
        "params/lum_mhsa/" + k.split("/", 1)[1]: a for k, a in flat_params(v).items()})
    tmod = lyt.MHSA(8, 4)
    tmod.load_state_dict({k[len("lum_mhsa."):]: t for k, t in sd.items()})
    out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(out.detach(), jmod.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("src, dst", [((3, 5), (7, 11)), ((4, 4), (32, 32)), ((5, 3), (8, 9))])
def test_nearest_upsample_is_jax_half_pixel_nearest(src, dst):
    x = np.random.default_rng(6).normal(0, 1, (1, *src, 2)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, *dst, 2), method="nearest")
    out = lyt._nearest(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    assert_close(out, ref, 0.0)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = shared_pair(pairs, "lyt_net_re", supervised_dp(hw=64, seed=4), **SMALL)
    check_round_trip(tm, v, mappings.lyt_net_name_map())
    keys = set(tm.module.state_dict())
    for k in ("process_y.0.weight", "lum_mhsa.query_dense.weight",
              "denoiser_cb.bottleneck.combine_heads.bias", "msef.layer_norm.norm.weight",
              "msef.depthwise_conv.weight", "msef.se_attn.fc1.weight"):
        assert k in keys, k


def test_config_trains_through_both_clis(tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"lol_v1/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.3)), ("ref", (0.2, 1.0)))}, hw=64)
    tiny_config("configs/lyt_net_re_lol_v1.py", tmp_path / "tiny.py", SMALL, image_size=64)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     supervised_dp(hw=64))
    assert name == "lyt_net_re"
    assert_clis_agree(jrun, prun, name)


@pytest.mark.parametrize("name", ["lyt_net_re", "lyt_net"])
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    assert tm.name == jm.name == "lyt_net_re"
    for attr in ("arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    struct = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            {"image": jnp.zeros((1, 64, 64, 3), jnp.float32)})
    assert tm.param_count() == sum(int(np.prod(a.shape))
                                   for a in jax.tree_util.tree_leaves(struct))
