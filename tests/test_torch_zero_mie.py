"""Port parity on the CPU: single-scale Zero-MIE (``zero_mie`` and its
rgb_d / hsv / hsv_d colour spaces and finer / gauss / relu layers), its
losses and filters against the JAX package.

The four losses the instance models add (registered under the JAX
package's names), kornia's bilateral blur; every name's training forward
and loss, ``FiLM`` and ``CrossAttentionLayer`` (flax attention's
DenseGeneral kernels through the bridge), the (ds, ds, 3) -> (3, ds, ds)
reinterpretation, and a 3-step fit against the JAX package's.

Tolerances: ops 1e-5 x max(1, max|ref|) (the depth-consistency loss's
Sobel mask exactly); the forward's inputs-side outputs (image_lr, depth_lr,
edge_lr, edge) 1e-5 x max(1, max|ref|) against the JAX package's float32.
The INR outputs and all that follows them (illu_lr, enhanced_lr, enhanced,
the loss) are held to the JAX package's forward in float64 within max(1e-5,
4 x its own float32 gap): FINER's sine arguments reach thousands (a
float32 step there is ~1e-3; the JAX package's own gap ~4e-4), and the
enhanced image comes through the bicubic fast guided filter, whose window
moments the port takes in float64. The fit: 1e-4 x max(1, max|ref|)
against the JAX package's 3-step fit (FINER's in float64, as above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.constants import LOSSES as JAX_LOSSES
from enhax.models.base import build_model as jax_build_model
from enhax.ops import filtering as jfilt
from enhax_torch.constants import LOSSES
from enhax_torch.models.base import build_model
from enhax_torch.models.llie import zero_mie
from enhax_torch.ops import filtering
from torch_instance_parity import assert_close, check_fit, check_forward_loss, datapoint, pair
from torch_instance_parity import one_torch_thread, pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"down_size": 32, "hidden_channels": 16}
NAMES = ["zero_mie", "zero_mie_rgb_d", "zero_mie_hsv", "zero_mie_hsv_d", "zero_mie_finer",
         "zero_mie_gauss", "zero_mie_relu"]
WITNESS = ("illu_lr", "enhanced_lr", "enhanced", "loss")


def _img(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("name, kw, two", [
    ("exposure_value_control_loss", {"mean_val": 0.4}, False),
    ("edge_aware_depth_consistency_loss", {"tau": 0.3}, True),
    ("edge_aware_loss", {}, True),
    ("depth_weighted_smoothness_loss", {"alpha": 2.0}, True)])
def test_losses_match_jax(name, kw, two):
    x, d = _img((2, 36, 32, 1), 0), _img((2, 36, 32, 1), 1)
    args = (x, d) if two else (x,)
    out = LOSSES.build(name, **kw)(*[torch.from_numpy(a) for a in args])
    assert_close(out, JAX_LOSSES.build(name, **kw)(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("tau", [0.0, 0.5, 1.5, 100.0])
def test_depth_consistency_mask_matches_jax(tau):
    """The loss's Sobel mask (zero padding, > tau) from an empty to a full
    one: the loss and its gradient as the JAX package's (0 at an empty
    mask)."""
    import jax
    d = _img((1, 24, 20, 1), 2)
    x = _img((1, 24, 20, 1), 3)
    fn = JAX_LOSSES.build("edge_aware_depth_consistency_loss", tau=tau)
    ref, gref = jax.value_and_grad(lambda a: fn(a, jnp.asarray(d)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    loss = LOSSES.build("edge_aware_depth_consistency_loss", tau=tau)(t, torch.from_numpy(d))
    loss.backward()
    assert_close(loss, ref)
    assert_close(t.grad, gref)
    assert (loss.item() == 0.0) == (tau == 100.0)


@pytest.mark.parametrize("ksize, sc, ss", [((3, 3), 0.5, (1.5, 1.5)), ((5, 3), 0.1, (2.0, 1.0))])
def test_bilateral_blur_matches_jax(ksize, sc, ss):
    x = _img((2, 20, 18, 3), 4)
    assert_close(filtering.bilateral_blur(torch.from_numpy(x), ksize, sc, ss),
                 jfilt.bilateral_blur(jnp.asarray(x), ksize, sc, ss))


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_jax(name, pairs):
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=5)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_forward_loss(jm, v, tm, dp, witness=WITNESS)


@pytest.mark.parametrize("cs", ["rgb_d"])
def test_film_and_cross_attention_match_jax(cs):
    """Both upstream-commented options on, with a given depth map."""
    kw = {**SMALL, "use_film": True, "use_cross_attn": True}
    dp = datapoint(jax_build_model("zero_mie_rgb_d"), hw=40, seed=6)
    dp["depth"] = _img((1, 40, 40, 1), 7, 0.2, 0.8)
    name = "zero_mie_" + cs

    jm, v, tm = pair(name, dp, **kw)
    jm.optional_inputs = tm.optional_inputs = ("depth",)
    assert hasattr(tm.module, "film") and hasattr(tm.module.cross_attn, "attn")
    check_forward_loss(jm, v, tm, dp, witness=WITNESS)


def test_reinterpretation_scrambles_the_channels_as_upstream():
    """(n, ds, ds, 3) read as (n, 3, ds, ds): the pixel (0, 0) of channel 1
    is element 1 of the flat (ds, ds, 3) buffer read at offset ds*ds."""
    ds = 4
    y = torch.arange(2 * ds * ds * 3, dtype=torch.float32).reshape(2, ds, ds, 3)
    out = zero_mie.as_channels_first(y, 2, 3, ds)
    assert out.shape == (2, ds, ds, 3)
    # out[b, i, j, c] is element c * ds * ds + i * ds + j of image b's buffer
    assert out[0, 0, 0, 1] == ds * ds
    assert out[1, 0, 1, 2] == ds * ds * 3 + 2 * ds * ds + 1
    assert not torch.equal(out, y)


@pytest.mark.parametrize("name", NAMES)
def test_three_step_fit_matches_jax(name, pairs):
    """3 Adam steps at the models' lr 1e-5 against the JAX package's fit;
    FINER's against the JAX fit in float64."""
    dp = datapoint(jax_build_model(name, **SMALL), hw=48, seed=8)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_fit(jm, v, tm, dp, witness="gap" if name == "zero_mie_finer" else None)


@pytest.mark.parametrize("name", NAMES)
def test_registry_entries_as_jax(name):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    for attr in ("arch", "tasks", "schemes", "required_inputs", "optional_inputs",
                 "instance_steps", "instance_lr", "instance_weight_decay"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.module.color_space == jm.module.color_space
