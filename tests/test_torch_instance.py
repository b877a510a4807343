"""Port parity: the instance path with Zero-DCE-V against the JAX package, on the CPU.

``rgb_to_hsv`` / ``hsv_to_rgb`` (values and the gradient through them, grey
pixels included), torch's bicubic resize, the fast guided filters, the
``zero_dce_v`` forward (weights through the bridge), and ``Predictor``'s
instance route (``make_instance_infer``) against the JAX ``Predictor``
after 3 fit steps; the route's kernel calls (none in the fit, one in the
clean forward), a fit that starts from the Predictor's weights on every
image, and bf16 kept float32.

Tolerances: the ops and the forward 1e-5 x max(1, max|ref|); the fit after
3 Adam steps 1e-4 x max(1, max|ref|) (the fit's loss and output). The
guided filter's slope is cov / (var + eps) with Zero-DCE-V's eps = 1e-8: in
a nearly flat window float32's cancellation in var reaches the output, and
the JAX package's own float32 result is up to 1.3e-4 from its float64
evaluation (the enhanced image; 5.3e-5 for V fixed). The port takes the
filter's moments in float64, so where the filter enters (the filter, V
fixed, the enhanced image) the port is held within 1e-5 of the JAX
package's functions evaluated in float64 (``jax.enable_x64``), a witness
computed apart from the port.

JAX's jitted forward (the Predictor's) can take a pure primary's hue,
exactly on a sector boundary, into the wrong sector: XLA rounds ``h * 6``
once for the sector and once for the fraction. The port maps primaries back
exactly (``test_hsv_matches_jax``, eager JAX), and the Predictor cases draw
images without them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.infer.engine import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax.ops import color as jcolor
from enhax.ops import filtering as jfilt
from enhax.ops.resize import resize_bicubic_torch as jax_bicubic
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import zero_dce
from enhax_torch.ops import color, filtering
from enhax_torch.ops import resize as tresize
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
TOL_FIT = 1e-4
TINY = {"num_channels": 8, "num_iters": 15, "down_size": 32}


def assert_close(out, ref, tol=TOL):
    out = out.detach().double().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err
    return err


def images(shape=(2, 24, 20), seed=0, special: bool = True) -> np.ndarray:
    """Random RGB; with ``special`` also grey pixels, pure colours, black and
    white, and pixels where two channels tie for the max."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    if not special:
        return x
    x[:, 0, :4] = x[:, 0, :4, :1]                      # grey
    x[:, 1, :6] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    x[:, 2, 0], x[:, 2, 1] = 0.0, 1.0                  # black, white
    x[:, 3, :, 1] = x[:, 3, :, 0]                      # r == g
    x[:, 4, :, 2] = x[:, 4, :, 1]                      # g == b
    return x


def test_hsv_matches_jax():
    x = images()
    assert_close(color.rgb_to_hsv(torch.from_numpy(x)), jcolor.rgb_to_hsv(jnp.asarray(x)))
    hsv = np.asarray(jcolor.rgb_to_hsv(jnp.asarray(x)))
    back = color.hsv_to_rgb(torch.from_numpy(hsv))
    assert_close(back, jcolor.hsv_to_rgb(jnp.asarray(hsv)))
    assert_close(back, x)   # the round trip


def test_hsv_gradients_match_jax():
    """d/dx of a weighted sum of rgb_to_hsv(x) and of hsv_to_rgb(hsv(x)):
    the hue's 1/(max - min) and the maximum's split at ties as JAX's."""
    x = images(seed=1)
    w = np.random.default_rng(2).uniform(-1, 1, x.shape).astype(np.float32)

    def jloss(a):
        h = jcolor.rgb_to_hsv(a)
        return jnp.sum(h * w) + jnp.sum(jcolor.hsv_to_rgb(h) * w[..., ::-1])

    ref = jax.grad(jloss)(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    h = color.rgb_to_hsv(t)
    loss = (h * torch.from_numpy(w)).sum() + (color.hsv_to_rgb(h) * torch.from_numpy(
        w[..., ::-1].copy())).sum()
    loss.backward()
    assert torch.isfinite(t.grad).all()
    assert_close(t.grad, ref)


@pytest.mark.parametrize("shape, size, align", [
    ((2, 16, 16, 1), (40, 24), True), ((1, 32, 24, 2), (64, 64), True),
    ((1, 30, 20, 3), (13, 9), False), ((2, 8, 12, 1), (8, 12), True),
])
def test_bicubic_resize_matches_jax(shape, size, align):
    """Up and down, align_corners on and off (the index clamping at both
    edges)."""
    x = np.random.default_rng(3).uniform(-1, 1, shape).astype(np.float32)
    out = tresize.resize_bicubic_torch(torch.from_numpy(x), size, align_corners=align)
    assert_close(out, jax_bicubic(jnp.asarray(x), size, align_corners=align))


def jax_float64(fn, *arrays, **kw):
    """``fn`` (of the JAX package) on ``arrays`` in float64: the witness."""
    with jax.enable_x64(True):
        out = fn(*[jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), a)
                   for a in arrays], **kw)
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), out)


@pytest.mark.parametrize("radius, eps", [(1, 1e-4), (2, 1e-4), (1, 1e-8)])
def test_guided_filters_match_jax(radius, eps):
    """Both filters within 1e-5 of the JAX package's in float64."""
    rng = np.random.default_rng(5)
    x_lr = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    y_lr = np.clip(x_lr ** 0.5 + rng.normal(0, 0.02, x_lr.shape), 0, 1).astype(np.float32)
    x_hr = rng.uniform(0, 1, (2, 40, 36, 1)).astype(np.float32)
    for port, ref, args in (
            (filtering.fast_guided_filter_bicubic, jfilt.fast_guided_filter_bicubic,
             (x_lr, y_lr, x_hr)),
            (filtering.fast_guided_filter, jfilt.fast_guided_filter, (y_lr, x_lr, x_hr))):
        out = port(*[torch.from_numpy(a) for a in args], radius=radius, eps=eps)
        assert_close(out, jax_float64(ref, *args, radius=radius, eps=eps))


def pair(**kw):
    """zero_dce_v in both packages, the JAX init's weights in the port
    through the bridge."""
    jm = jax_build_model("zero_dce_v", **{**TINY, **kw})
    v = jm.init(jax.random.PRNGKey(7), {"image": jnp.zeros((1, 64, 64, 3))})
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(v)[0]:
        flat["/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(leaf)
    tm = build_model("zero_dce_v", device="cpu", **{**TINY, **kw})
    tm.module.load_state_dict(jax_to_torch_state_dict("zero_dce_v", flat), strict=True)
    return jm, v, tm


def test_zero_dce_v_forward_matches_jax():
    """Every output of the forward (the max over the whole batch included),
    with the curves applied by ``fused_curve_apply``'s plain version
    (no_grad) and by ``apply_curves`` (autograd): the curves and V within
    1e-5 of JAX's, V fixed and the enhanced image (the guided filter's)
    within 1e-5 of JAX's forward in float64."""
    jm, v, tm = pair()
    x = images((2, 48, 40), seed=6) * 0.4
    ref = jm.apply(v, {"image": jnp.asarray(x)})
    witness = jax_float64(lambda w, b: jm.apply(w, b), v, {"image": x})
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            out = tm.apply({"image": torch.from_numpy(x)}, training=grad)
        assert set(out) == set(ref)
        for k in ("adjust", "image_v"):
            assert_close(out[k], ref[k])
        for k in ("image_v_fixed", "enhanced"):
            assert_close(out[k], witness[k])
    assert tm.param_count() == sum(a.size for a in jax.tree_util.tree_leaves(v))


def test_instance_predictor_matches_jax_after_three_steps(monkeypatch):
    """``Predictor`` on zero_dce_v with ``instance_steps`` 3: ``fit_loss``
    and the enhanced image against the JAX Predictor's (its jitted scan of
    the same Adam steps). The fit calls the curve kernel's wrapper in none
    of its steps and once in the clean forward."""
    jm, v, tm = pair()
    jm, tm = (dataclasses.replace(m, instance_steps=3) for m in (jm, tm))
    x = images((1, 48, 40), seed=8, special=False) * 0.3
    ref = JaxPredictor(jm, variables=v)({"image": x})
    calls = []
    wrapper = zero_dce.fused_curve_apply
    monkeypatch.setattr(zero_dce, "fused_curve_apply",
                        lambda *a, **k: calls.append(a[0].shape) or wrapper(*a, **k))
    before = zero_dce.ZeroDCE.curve_loop_forwards
    out = Predictor(tm, device="cpu")({"image": x})
    assert calls == [(1, 32, 32, 1)]
    assert zero_dce.ZeroDCE.curve_loop_forwards == before + 3
    assert_close(out["fit_loss"], ref["fit_loss"], TOL_FIT)
    assert_close(out["enhanced"], ref["enhanced"], TOL_FIT)
    assert out["enhanced"].shape == (1, 48, 40, 3) and out["time"] > 0


def test_every_image_starts_from_the_predictors_weights():
    """Two requests of one image give the same answer, and the Predictor's
    module is not stepped; a different image fits to its own answer."""
    _, _, tm = pair()
    tm = dataclasses.replace(tm, instance_steps=2, instance_lr=1e-2)
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    pred = Predictor(tm, device="cpu")
    x = images((1, 32, 32), seed=9) * 0.3
    a, b = pred({"image": x}), pred({"image": x})
    assert torch.equal(a["enhanced"], b["enhanced"]) and a["fit_loss"] == b["fit_loss"]
    for k, t in tm.module.state_dict().items():
        assert torch.equal(t, before[k]), k
    c = pred({"image": images((1, 32, 32), seed=10) * 0.3})
    assert c["fit_loss"] != a["fit_loss"]


def test_instance_predictor_keeps_float32_under_bf16(capsys):
    _, _, tm = pair()
    tm = dataclasses.replace(tm, instance_steps=1)
    pred = Predictor(tm, bf16=True, device="cpu")
    assert "keeping float32 weights" in capsys.readouterr().out
    out = pred({"image": images((1, 32, 32), seed=11) * 0.3})
    assert out["enhanced"].dtype == torch.float32 and tm.dtype == torch.float32


def test_instance_fit_uses_adamw_with_weight_decay():
    """``instance_weight_decay`` fits with AdamW: a different answer from
    Adam's on the same image."""
    _, _, tm = pair()
    x = {"image": images((1, 32, 32), seed=12) * 0.3}
    base = dataclasses.replace(tm, instance_steps=2, instance_lr=1e-2)
    adam = Predictor(base, device="cpu")(x)
    adamw = Predictor(dataclasses.replace(base, instance_weight_decay=0.5), device="cpu")(x)
    assert not torch.equal(adam["enhanced"], adamw["enhanced"])


def test_zero_dce_v_registry_entry_as_jax():
    jm = jax_build_model("zero_dce_v")
    tm = build_model("zero_dce_v", device="cpu")
    assert (tm.instance_steps, tm.instance_lr, tm.instance_weight_decay) == (
        jm.instance_steps, jm.instance_lr, jm.instance_weight_decay) == (100, 1e-4, 0.0)
    assert tm.tasks == jm.tasks and tm.schemes == jm.schemes
    assert tm.module.down_size == 256 and tm.module.e_conv1.in_channels == 1
    assert tm.module.e_conv7.out_channels == 15
