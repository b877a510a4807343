"""Port parity on the CPU: ZID (zero-shot dehazing) against the JAX
package, and the weight bridge's rules for the instance models.

The corner-aligned bilinear resize; the colour guided filter (radius 50,
a 3x3 solve a pixel) against the JAX package's in float64; the dark channel
and the airlight's top-k (ties broken toward the lower index as
``jax.lax.top_k`` does: the selected values exactly); StdLoss; the forward
and loss at 64x64 (the VAE's size to match) with numpy-drawn weights,
BatchNorm statistics included; a 3-step fit against the JAX package's, and
the same fit with the statistics left out of it, which must not match. The
bridge: a Dense kernel becomes an ``nn.Linear`` weight, ``batch_stats``
the BatchNorms' ``mean``/``var`` parameters, ``density_k`` stays.

Tolerances: 1e-5 x max(1, max|ref|) for ops, forward and loss, exactly for
the dark channel and the selected airlight; the fit 1e-4 x max(1,
max|ref|) on fit_loss and every output. The colour guided filter's float32
evaluation cancels (E[II] - E[I]E[I] over 101 x 101 windows, then a 3x3
solve): the port takes it in float64, and the filter and the enhanced image
are held to the JAX package's functions in float64 within max(1e-5, 4 x
the JAX package's own float32 gap).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer.engine import make_instance_infer as jax_instance_infer
from enhax.models.base import build_model as jax_build_model
from enhax.models.dehaze import zid as jzid
from enhax.ops.resize import resize_align_corners as jax_align_corners
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer.engine import make_instance_infer
from enhax_torch.models.base import build_model
from enhax_torch.models.dehaze import zid
from enhax_torch.ops.resize import resize_align_corners
from torch_instance_parity import (TOL_FIT, assert_close, assert_witnessed,
                                   check_forward_loss, flat_params, jax_float64, pair, rel_err,
                                   to_torch)
from torch_instance_parity import one_torch_thread  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

KW = {"image_size": (64, 64)}
OUTS = ("fit_loss", "enhanced", "image", "mask", "ambient")


def _img(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("shape, size", [((2, 4, 6, 3), (8, 12)), ((1, 5, 3, 2), (9, 7)),
                                         ((1, 8, 8, 1), (8, 8))])
def test_resize_align_corners_matches_jax(shape, size):
    x = _img(shape, 0)
    assert_close(resize_align_corners(torch.from_numpy(x), size),
                 jax_align_corners(jnp.asarray(x), size))


def test_color_guided_filter_against_jax_in_float64():
    """A low-contrast (hazy) guide, where the guide's window variance is
    small and float32 cancels most."""
    guide, src = _img((1, 64, 60, 3), 1, 0.6, 0.7), _img((1, 64, 60, 1), 2)
    out = zid.color_guided_filter(torch.from_numpy(guide), torch.from_numpy(src))
    ref32 = jzid.color_guided_filter(jnp.asarray(guide), jnp.asarray(src))
    ref64 = jax_float64(lambda g, s: jzid.color_guided_filter(g, s), guide, src)
    err, gap = assert_witnessed(out, ref32, ref64)
    assert err < 1e-7 < gap   # the port: its float64 result rounded to float32


def test_dark_channel_and_airlight_match_jax():
    """The airlight at 64x64 (top 1) and at 128x160 (top 2). A bright patch
    whose channel minimum is flat (0.95) ties the eroded dark channel over
    its interior, and its green channel differs from pixel to pixel: the
    airlight is the green of the pixels picked among the ties (the lowest
    indices, as the JAX package's ``top_k``)."""
    for shape in ((2, 64, 64, 3), (1, 128, 160, 3)):
        x = _img(shape, 3)
        x[:, 10:40, 20:50] = 0.95
        x[:, 10:40, 20:50, 1] = np.linspace(0.99, 0.96, 900, dtype=np.float32).reshape(30, 30)
        out = zid.atmospheric_prior(torch.from_numpy(x))
        assert_close(out, jzid.atmospheric_prior(jnp.asarray(x)), 0.0)
        assert 0.96 < float(out[0, 0, 0, 1]) < 0.99
    dark = zid.dark_channel(torch.from_numpy(x))
    assert dark.shape == (1, 128, 160, 1)
    assert float(dark.max()) == float(np.float32(0.95))


def test_std_loss_matches_jax():
    x = _img((2, 30, 26, 3), 4)
    assert_close(zid.std_loss(torch.from_numpy(x)), jzid._std_loss(jnp.asarray(x)))


@pytest.fixture(scope="module")
def fitted():
    """zid at 64x64 with numpy-drawn weights (BatchNorm statistics away
    from their init) and the JAX package's 3-step fit of one hazy image."""
    dp = {"image": _img((1, 64, 64, 3), 5, 0.3, 0.95)}
    jm, v, tm = pair("zid", dp, init="numpy", seed=6, **KW)
    ref = jax_instance_infer(jm, 3, jm.instance_lr)(v, dp, jax.random.PRNGKey(0))
    return jm, v, tm, dp, ref


def test_forward_and_loss_match_jax(fitted):
    jm, v, tm, dp, _ = fitted
    check_forward_loss(jm, v, tm, dp, witness=("enhanced",))


def test_three_step_fit_matches_jax(fitted):
    """3 Adam steps at lr 1e-3 over every parameter, the BatchNorm
    statistics included: fit_loss and every output of the clean forward."""
    jm, v, tm, dp, ref = fitted
    out = make_instance_infer(tm, 3, tm.instance_lr)(to_torch(dp))
    for k in OUTS:
        assert_close(out[k], ref[k], TOL_FIT)


def test_fit_without_the_statistics_does_not_match_jax(fitted):
    """The same 3 steps with the BatchNorms' mean and var left out of the
    optimizer (buffers, as torch's own BatchNorm keeps them) land elsewhere:
    the outputs differ from the JAX package's fit by more than TOL_FIT."""
    jm, v, tm, dp, ref = fitted
    fit = dataclasses.replace(tm, module=copy.deepcopy(tm.module))
    params = [p for n, p in fit.module.named_parameters() if not n.endswith((".mean", ".var"))]
    opt = torch.optim.Adam(params, lr=tm.instance_lr)
    for _ in range(3):
        opt.zero_grad()
        fit.forward_loss(to_torch(dp))[0].backward()
        opt.step()
    with torch.no_grad():
        out = fit.apply(to_torch(dp))
    assert max(rel_err(out[k], ref[k]) for k in ("image", "mask", "ambient")) > 10 * TOL_FIT


def test_instance_fit_refuses_state_in_buffers():
    tm = build_model("zid", device="cpu", **KW)
    bn = tm.module.image_net.l0_d1_bn
    mean = bn.mean.detach().clone()
    del bn.mean
    bn.register_buffer("mean", mean)
    with pytest.raises(ValueError, match="buffers"):
        make_instance_infer(tm, 1)


@pytest.mark.parametrize("name", ["zid", "colie_re"])
def test_bridge_loads_jax_models(name):
    """Every variable of a JAX ``zid`` / ``colie_re`` becomes a port
    parameter (strict load, same count): Dense kernels transposed into
    ``nn.Linear`` weights, ZID's ``batch_stats`` into ``mean``/``var``."""
    dp = {"image": _img((1, 64, 64, 3), 7)}
    kw = KW if name == "zid" else {"down_size": 32, "hidden_dim": 16}
    jm = jax_build_model(name, **kw)
    from torch_instance_parity import drawn_variables
    v = drawn_variables(jm, {"image": jnp.asarray(dp["image"])}, seed=8)
    flat = flat_params(v)
    sd = jax_to_torch_state_dict(name, flat)
    tm = build_model(name, device="cpu", **kw)
    tm.module.load_state_dict(sd, strict=True)
    assert set(sd) == set(dict(tm.module.named_parameters()))
    if name == "zid":
        assert torch.equal(sd["image_net.l3_skip_bn.var"],
                           torch.from_numpy(flat["batch_stats/image_net/l3_skip_bn/var"].copy()))
        assert torch.equal(sd["ambient_net.fc1.weight"],
                           torch.from_numpy(flat["params/ambient_net/fc1/kernel"].T.copy()))
        assert sd["ambient_net.fc1.weight"].shape == (100, 2048)
    else:
        assert torch.equal(sd["output_net.lin1.weight"],
                           torch.from_numpy(flat["params/output_net/lin1/kernel"].T.copy()))
        assert torch.equal(sd["patch_net.sine0.linear.weight"],
                           torch.from_numpy(flat["params/patch_net/sine0/Dense_0/kernel"].T.copy()))


def test_registry_entry_as_jax():
    jm, tm = jax_build_model("zid"), build_model("zid", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "instance_steps",
                 "instance_lr", "instance_weight_decay", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.module.ambient_net.fc1.in_features == 128 * 8 * 8
