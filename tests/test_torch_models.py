"""Port parity: layers, Zero-DCE models, registry and weight bridge.

One set of JAX weights goes through ``jax_to_torch_state_dict`` into the
port; both forwards run on the CPU in float32.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import enhax
import enhax_torch
from enhax.models.base import build_model as jax_build_model
from enhax.models.llie.zero_dce import dce_init
from enhax.nn.layers import DSConv as JaxDSConv
from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from enhax_torch.models.base import build_model
from enhax_torch.nn.layers import DSConv, conv3x3
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def flat_params(variables) -> dict:
    """The flat-key format of enhax.train.checkpoints.save_params_npz."""
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        flat[key] = np.asarray(leaf)
    return flat


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_registry_names_and_aliases():
    for name in ("zero_dce_re", "zero_dce++_re", "zero_dcepp_re", "zero_dce++",
                 "zero_dcepp", "zero_dce", "Zero-DCE-RE"):
        assert name in enhax_torch.MODELS
        assert name in enhax.MODELS
        assert (enhax_torch.MODELS.canonical_name(name)
                == enhax.MODELS.canonical_name(name))
    assert "zero_dce" in enhax_torch.MODELS.archs
    assert sorted(enhax_torch.MODELS.models_for_arch("zero_dce")) == [
        "sgz", "zero_dce++_re", "zero_dce_re", "zero_dce_v", "zero_didce"]
    assert (sorted(enhax_torch.MODELS.models_for_arch("zero_dce"))
            == sorted(enhax.MODELS.models_for_arch("zero_dce")))


def test_dsconv_matches_jax(rng):
    x = rng.uniform(-1, 1, (2, 16, 12, 8)).astype(np.float32)
    jm = JaxDSConv(features=32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    flat = {f"params/dce/e_conv1/{k}": v
            for k, v in flat_params(variables["params"]).items()}
    sd = jax_to_torch_state_dict("zero_dce++_re", flat)
    layer = DSConv(8, 32)
    layer.load_state_dict({k.removeprefix("e_conv1."): v for k, v in sd.items()})
    out = layer(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_conv3x3_matches_jax(rng):
    x = rng.uniform(-1, 1, (2, 16, 12, 8)).astype(np.float32)
    jm = fnn.Conv(24, (3, 3), kernel_init=dce_init)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    flat = {f"params/dce/e_conv7/{k}": v
            for k, v in flat_params(variables["params"]).items()}
    sd = jax_to_torch_state_dict("zero_dce_re", flat)
    layer = conv3x3(8, 24)
    layer.load_state_dict({k.removeprefix("e_conv7."): v for k, v in sd.items()})
    out = layer(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=TOL)


def _parity(name: str, shape, seed: int, **kw):
    x = np.random.default_rng(seed).uniform(0, 0.4, shape).astype(np.float32)
    jm = jax_build_model(name, **kw)
    variables = jm.init(jax.random.PRNGKey(seed), {"image": jnp.asarray(x)})
    ref = jm.apply(variables, {"image": jnp.asarray(x)})
    tm = build_model(name, device="cpu", **kw)
    tm.module.load_state_dict(jax_to_torch_state_dict(name, flat_params(variables)))
    with torch.inference_mode():
        out = tm.apply({"image": torch.from_numpy(x)})
    assert set(out) == set(ref) == {"enhanced", "adjust"}
    for key in ("enhanced", "adjust"):
        assert tuple(out[key].shape) == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL,
                                   err_msg=key)
    return tm


@pytest.mark.parametrize("name, sf, shape", [
    ("zero_dce_re", 1.0, (2, 32, 48, 3)),
    ("zero_dce++_re", 1.0, (2, 32, 48, 3)),
    ("zero_dce++_re", 2.0, (2, 32, 48, 3)),
    ("zero_dce++_re", 4.0, (2, 32, 48, 3)),
    ("zero_dce++_re", 8.0, (2, 32, 48, 3)),
    # not an integer ratio, or H/W not multiples of sf: the full-resolution
    # curve goes to fused_curve_apply, with int(H/sf) truncation
    ("zero_dce++_re", 2.5, (1, 40, 56, 3)),
    ("zero_dce++_re", 3.0, (1, 40, 56, 3)),
])
def test_zero_dce_models_match_jax(name, sf, shape):
    kw = {"num_channels": 8}
    if name == "zero_dce++_re":
        kw["scale_factor"] = sf
    _parity(name, shape, seed=3, **kw)


@pytest.mark.parametrize("name, kw", [("zero_dce_re", {}),
                                      ("zero_dce++_re", {"scale_factor": 8.0})])
def test_zero_dce_models_full_width_match_jax(name, kw):
    tm = _parity(name, (1, 64, 64, 3), seed=4, **kw)
    # the published widths: Zero-DCE ~79K params, Zero-DCE++ ~10K
    jm = jax_build_model(name, **kw)
    variables = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    assert tm.param_count() == jm.param_count(variables)


def test_bridge_rejects_unmatched_key():
    with pytest.raises(KeyError, match="matches no rule"):
        jax_to_torch_state_dict("zero_dce_re", {"params/head/kernel": np.zeros((3, 3, 3, 3))})
    # a model of the JAX package the port has no counterpart of (CoLIE, the
    # name here before, is ported)
    with pytest.raises(KeyError, match="retinexformer"):
        jax_to_torch_state_dict("retinexformer", {})


@pytest.mark.parametrize("model, key, shape", [
    ("zero_dce_re", "params/dce/e_conv1/kernel", (3, 3, 3)),
    ("zero_dce_re", "params/dce/e_conv1/bias", (32, 1)),
    ("zero_dce++_re", "params/dce/e_conv1/depthwise/kernel", (3, 3, 2, 3)),
    ("zero_dce++_re", "params/dce/e_conv1/pointwise/kernel", (3, 3, 3, 32)),
])
def test_bridge_rejects_mis_shaped_array(model, key, shape):
    with pytest.raises(ValueError):
        jax_to_torch_state_dict(model, {key: np.zeros(shape, np.float32)})


def test_bridge_rejects_bias_of_other_width():
    flat = {"params/dce/e_conv1/kernel": np.zeros((3, 3, 3, 32), np.float32),
            "params/dce/e_conv1/bias": np.zeros((16,), np.float32)}
    with pytest.raises(ValueError, match="bias"):
        jax_to_torch_state_dict("zero_dce_re", flat)


def test_bridge_keys_are_the_reference_torch_names():
    jm = jax_build_model("zero_dce++_re")
    variables = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros((1, 32, 32, 3))})
    sd = jax_to_torch_state_dict("zero_dce++_re", flat_params(variables))
    assert "e_conv1.dw_conv.weight" in sd and "e_conv7.pw_conv.bias" in sd
    assert tuple(sd["e_conv1.dw_conv.weight"].shape) == (3, 1, 3, 3)
    assert tuple(sd["e_conv2.pw_conv.weight"].shape) == (32, 32, 1, 1)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from enhax_torch.infer import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("zero_dce++_re")
    model = build_model("zero_dce++_re", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model)


def test_build_model_is_seeded():
    a = build_model("zero_dce_re", device="cpu", seed=5).module.state_dict()
    b = build_model("zero_dce_re", device="cpu", seed=5).module.state_dict()
    c = build_model("zero_dce_re", device="cpu", seed=6).module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["e_conv1.weight"], c["e_conv1.weight"])


def test_port_imports_no_jax():
    code = ("import sys, enhax_torch, enhax_torch.cli.predict, "
            "enhax_torch.convert.from_jax, enhax_torch.infer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'enhax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|enhax)\b(?!_torch)")
    offenders = [f"{p}:{i}" for p in sorted((REPO / "enhax_torch").rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.match(line)]
    assert offenders == []
