"""Port parity on the CPU: MPRNet (``mprnet``) against the JAX package at a
narrow width (channels 8, s_unet 4, s_ors 4, one CAB an ORB).

The training forward (``enhanced``, ``stage1``, ``stage2``) and the loss
(``edge_charbonnier_loss`` summed over the three) within 1e-5 x max(1,
max|ref|) in float32, every gradient within 1e-4 x max|ref| in float64, on
32x32 (quadrants of 16x16, the encoder down to 4x4); the 0.5x / 2x
bilinear resamples against ``jax.image.resize`` at even and odd sizes; the
reference names read back by the JAX package's own loader, and a state dict
whose CABs share one PReLU (the reference's) loaded as it is; a 37x45
request through both packages' ``Predictor``s (padded to 48x48 by the
divisor 16, every output cropped back); the registry entry. Two train steps
through both train CLIs: ``tests/test_torch_mprnet_cli.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.convert import mappings
from enhax.infer import Predictor as JaxPredictor
from enhax.models.base import build_model as jax_build_model
from enhax.models.multitask import mprnet as jmpr
from enhax_torch.infer import Predictor
from enhax_torch.models.base import build_model
from enhax_torch.models.multitask import mprnet as mpr
from test_torch_lllinet import supervised_dp
from torch_family_parity import check_forward_loss_grads, check_round_trip
from torch_instance_parity import (assert_close, pairs, shared_pair)  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"channels": 8, "s_unet": 4, "s_ors": 4, "num_cab": 1}


def _pair(pairs):
    """The shared pair, the JAX variables drawn with numpy."""
    return shared_pair(pairs, "mprnet", supervised_dp(hw=32, seed=3), init="numpy", **SMALL)


def test_forward_loss_and_gradients_match_jax(pairs):
    jm, v, tm = _pair(pairs)
    check_forward_loss_grads(jm, v, tm, supervised_dp(hw=32, seed=3), grads32=False)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9), (16, 5)])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_bilinear_resample_is_jax_resize(hw, scale):
    x = np.random.default_rng(4).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = jmpr._bilinear(jnp.asarray(x), scale)
    out = mpr._Bilinear(scale)(torch.from_numpy(x))
    assert_close(out, ref, 1e-6)


def test_bridge_round_trip_under_the_reference_names(pairs):
    jm, v, tm = _pair(pairs)
    check_round_trip(tm, v, mappings.mprnet_name_map(num_cab=1))
    keys = set(tm.module.state_dict())
    for k in ("shallow_feat1.0.weight", "shallow_feat1.1.body.1.weight",
              "stage1_encoder.encoder_level2.1.CA.conv_du.2.weight",
              "stage2_encoder.csff_dec3.weight", "stage1_decoder.up32.up.1.weight",
              "stage2_decoder.skip_attn1.body.0.weight", "stage1_encoder.down12.down.1.weight",
              "stage3_orsnet.orb2.body.1.weight", "stage3_orsnet.up_enc2.1.up.1.weight",
              "sam23.conv3.weight", "concat23.weight", "tail.weight"):
        assert k in keys, k


def test_one_shared_prelu_loads_into_every_cab(pairs):
    """The reference passes one ``nn.PReLU`` to every CAB: its state dict
    holds the same tensor under each CAB's ``body.1.weight``."""
    _, _, tm = _pair(pairs)
    prelus = {f"{n}.weight" for n, mod in tm.module.named_modules()
              if isinstance(mod, mpr._PReLU)}
    # two encoders and two decoders of 3 levels x 2 CABs, their 4 skip CABs,
    # the 3 shallow CABs, one CAB in each of the 3 ORBs
    assert len(prelus) == 4 * 3 * 2 + 4 + 3 + 3
    assert all(k.endswith(".body.1.weight") for k in prelus)
    shared = torch.full((1,), 0.125)
    sd = {k: shared if k in prelus else t for k, t in tm.module.state_dict().items()}
    m = build_model("mprnet", device="cpu", **SMALL)
    m.module.load_state_dict(sd, strict=True)
    assert all(float(m.module.get_parameter(k)) == 0.125 for k in prelus)


def test_predictor_pads_to_16_and_crops_as_jax(pairs):
    jm, v, tm = _pair(pairs)
    x = np.random.default_rng(5).uniform(0.05, 0.9, (2, 37, 45, 3)).astype(np.float32)
    ref = JaxPredictor(jm, variables=v).infer({"image": x})
    out = Predictor(tm, device="cpu").infer({"image": x})
    assert tm.size_divisor == jm.size_divisor == 16
    for key in ("enhanced", "stage1", "stage2"):
        assert out[key].shape == x.shape, key
        assert_close(out[key], ref[key])


def test_registry_entry_as_jax():
    """At the published width (96, 48, 32, 8 CABs): the JAX package's
    variables count 20,127,127 (``jax.eval_shape`` of its init)."""
    jm, tm = jax_build_model("mprnet"), build_model("mprnet", device="cpu")
    for attr in ("name", "arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.param_count() == 20_127_127
