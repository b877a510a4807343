"""Port parity on the CPU: AdaIR (``adair``) against the JAX package at a
narrow width (dim 8, one block a level, one refinement block) with
``fre_n`` 8, so that the frequency box is not empty below 128 rows.

On 64x64 the three FreModules work at 8x8 (``fre1``: h // 8 = 1, so its box
is always empty), 16x16 (``fre2``) and 32x32 (``fre3``). The box's
half-sizes ``int((h // n) * rate)`` are compared between the packages, on
an input whose every product (h // n) * rate lies at least 1e-3 from an
integer (a flipped truncation then reads as a flip, not as a numeric gap),
and the box is not empty in one module at least. On that input: the
training forward and the L1 loss within 1e-5 x max(1, max|ref|) in
float32, every gradient within 1e-4 x max|ref| in float64 (the JAX
package's with its norm's gradient at a zero vector 0, as torch's: its own
is NaN wherever a box is empty, which the test also holds); the reference
names read back by the JAX package's own loader, ``para1``/``para2``
loaded from the reference's (dim, 1, 1); the registry entry. A ragged
request through both packages' ``Predictor``s and two train steps through
both train CLIs: ``tests/test_torch_adair_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax.models.multitask import adair as jadair
from enhax_torch.models.base import build_model
from enhax_torch.models.multitask.adair import frequency_box
from test_torch_llie_zero_ref_rsfnet_fit import _NormZeroGradAtZero
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import pairs, shared_pair, to_torch  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement": 1, "fre_n": 8}
FRES = ("fre1", "fre2", "fre3")
MARGIN = 1e-3


def _dp(seed: int, hw: int = 64, n: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.05, 0.95, (n, hw, hw, 3)).astype(np.float32)
    return {"image": (ref * rng.uniform(0.3, 1.0, (n, 1, 1, 1)) + rng.uniform(
        0, 0.1, ref.shape)).astype(np.float32), "ref_image": ref}


def _port_products(tm, image: np.ndarray) -> dict:
    """Each FreModule's (h // n) * rate, (B, 2), from the port's forward."""
    seen = {}

    def hook(name, size):
        def fn(module, args, out):
            rate = torch.sigmoid(out.detach()).double()[:, 0, 0, :]
            seen[name] = (rate * torch.tensor([size[0], size[1]], dtype=torch.float64)).numpy()
        return fn

    handles = []
    for name, scale in zip(FRES, (8, 4, 2)):
        size = tuple(s // scale // SMALL["fre_n"] for s in image.shape[1:3])
        handles.append(getattr(tm.module, name).rate_conv[2].register_forward_hook(
            hook(name, size)))
    try:
        with torch.no_grad():
            tm.module(torch.from_numpy(image))
    finally:
        for h in handles:
            h.remove()
    return seen


def _jax_products(jm, v, image: np.ndarray) -> dict:
    _, state = jax.jit(lambda w, x: jm.module.apply(w, x, capture_intermediates=True,
                                                    mutable=["intermediates"]))(
        v, jnp.asarray(image))
    out = {}
    for name, scale in zip(FRES, (8, 4, 2)):
        logits = np.asarray(state["intermediates"][name]["rate2"]["__call__"][0], np.float64)
        size = np.array([s // scale // SMALL["fre_n"] for s in image.shape[1:3]], np.float64)
        out[name] = 1 / (1 + np.exp(-logits[:, 0, 0, :])) * size
    return out


def _boxed(products: dict) -> bool:
    """Every product at least MARGIN from an integer, a box not empty."""
    far = all(np.abs(p - np.round(p)).min() >= MARGIN for p in products.values())
    return far and any((p.astype(np.int64) > 0).all(axis=-1).any() for p in products.values())


def _pair(pairs):
    """The shared pair, and the first input (by seed) whose boxes
    ``_boxed`` accepts in the port."""
    jm, v, tm = shared_pair(pairs, "adair", _dp(0), init="numpy", **SMALL)
    if "adair_seed" not in pairs:
        pairs["adair_seed"] = next(s for s in range(100)
                                   if _boxed(_port_products(tm, _dp(s)["image"])))
    return jm, v, tm, _dp(pairs["adair_seed"])


def test_frequency_boxes_match_jax_and_one_is_not_empty(pairs):
    jm, v, tm, dp = _pair(pairs)
    port, ref = _port_products(tm, dp["image"]), _jax_products(jm, v, dp["image"])
    assert _boxed(port) and _boxed(ref)
    for name in FRES:
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-5, err_msg=name)
        np.testing.assert_array_equal(port[name].astype(np.int64), ref[name].astype(np.int64))
    assert (port["fre1"].astype(np.int64) == 0).all()   # 8 rows: h // 8 = 1, rate < 1
    rate = torch.tensor([[0.2, 0.9], [0.5, 0.99]], dtype=torch.float32)
    h_, w_ = frequency_box(rate, 32, 64, 8)
    assert h_.tolist() == [0, 2] and w_.tolist() == [7, 7]


@pytest.fixture
def zero_grad_norm_at_zero(monkeypatch):
    """The JAX package's channel attention with its norm's gradient 0 at a
    zero vector, as torch's (``test_jax_gradient_is_nan_at_an_empty_box``)."""
    monkeypatch.setattr(jadair, "jnp", _NormZeroGradAtZero())


def test_jax_gradient_is_nan_at_an_empty_box_and_the_ports_is_not(pairs):
    """The deliberate difference. An empty box leaves the low part 0, so the
    cross attention's q (no bias) is a zero vector, whose norm's gradient is
    NaN in the JAX package (``jnp.linalg.norm``) and 0 in torch. At fre1's 8
    rows the box is always empty (above), so the JAX package's gradients of
    what feeds that q are NaN; the port's are finite (0 where no path
    reaches: the rates reach the loss only through the box's truncation)."""
    jm, v, tm, dp = _pair(pairs)
    cca = v["params"]["fre1"]["cross_h"]
    y = np.random.default_rng(2).normal(0, 1, (1, 8, 8, 64)).astype(np.float32)
    zero = np.zeros_like(y)
    module = jadair._ChannelCrossAttention(64, 4)
    grads = jax.jit(jax.grad(lambda w: jnp.sum(module.apply({"params": w}, zero, y))))(cca)
    assert np.isnan(np.asarray(grads["q"]["kernel"])).all()
    tm.module.zero_grad(set_to_none=True)
    tm.forward_loss(to_torch(dp))[0].backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.module.parameters()
               if p.grad is not None)
    assert torch.isfinite(tm.module.fre1.conv1.weight.grad).all()
    tm.module.zero_grad(set_to_none=True)


def test_forward_loss_and_gradients_match_jax(pairs, zero_grad_norm_at_zero):
    jm, v, tm, dp = _pair(pairs)
    check_forward_loss_grads(jm, v, tm, dp, grads32=False)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm, _ = _pair(pairs)
    check_round_trip(tm, v, mappings.adair_name_map(num_blocks=(1, 1, 1, 1), num_refinement=1))
    keys = set(tm.module.state_dict())
    for k in ("patch_embed.proj.weight", "latent.0.attn.qkv_dwconv.weight",
              "fre1.conv1.weight", "fre2.rate_conv.2.weight",
              "fre3.channel_cross_agg.kv_dwconv.weight", "fre3.channel_cross_l.temperature",
              "fre1.frequency_refine.SpatialGate.spatial.weight",
              "fre2.frequency_refine.ChannelGate.mlp.2.weight",
              "fre3.frequency_refine.proj.bias", "fre2.para1", "reduce_chan_level3.weight",
              "refinement.0.ffn.dwconv.weight", "output.weight"):
        assert k in keys, k


def test_gains_load_from_the_reference_shape(pairs):
    _, _, tm, _ = _pair(pairs)
    sd = dict(tm.module.state_dict())
    for name in ("para1", "para2"):
        sd[f"fre3.{name}"] = torch.arange(16, dtype=torch.float32).reshape(16, 1, 1) + 1
    m = build_model("adair", device="cpu", **SMALL)
    m.module.load_state_dict(sd, strict=True)
    assert m.module.fre3.para1.shape == (16,)
    assert m.module.fre3.para2.tolist() == list(range(1, 17))


def test_registry_entry_as_jax():
    """At the published width (dim 48, blocks (4, 6, 6, 8), 4 refinement
    blocks, fre_n 128): the JAX package's variables count 28,766,086
    (``jax.eval_shape`` of its init)."""
    jm, tm = jax_build_model("adair"), build_model("adair", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.param_count() == 28_766_086
    assert tm.module.fre1.n == 128 and jm.module.fre_n == 128
