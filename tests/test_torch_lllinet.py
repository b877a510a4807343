"""Port parity on the CPU: LLUNet++ (``llunet++_re`` and its aliases) and
LLLiNet (``lllinet``, ``lllinet_hvi``) against the JAX package, at narrow
widths (filters (4, 8, 8, 16, 16): every node and level kept) on 32x32.

The training forward and the loss within 1e-5 x max(1, max|ref|), every
parameter's gradient within 1e-4 x max|ref| of its tensor, on the JAX
package's init carried over by the bridge; the bridge's reference names
read back by the JAX package's own loader; one shipped config each through
both train CLIs for 2 steps on a fabricated ``lol_v1`` tree (loss and
params within 1e-5 x max(1, max|ref|)); the registry entries."""

import numpy as np
import pytest

from enhax.convert import mappings
from enhax.models.base import build_model as jax_build_model
from enhax_torch.models.base import build_model
from torch_family_parity import (assert_clis_agree, check_forward_loss_grads, check_round_trip,
                                 fabricate, run_both_clis, tiny_config)
from torch_instance_parity import pairs, shared_pair  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401

SMALL = {"filters": (4, 8, 8, 16, 16)}
NAMES = ["llunet++_re", "lllinet", "lllinet_hvi"]


def supervised_dp(hw: int = 32, seed: int = 0, n: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0.05, 0.95, (n, hw, hw, 3)).astype(np.float32)
    return {"image": (ref * rng.uniform(0.1, 0.4, (n, 1, 1, 1))).astype(np.float32),
            "ref_image": ref}


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_gradients_match_jax(name, pairs):
    dp = supervised_dp(seed=1)
    jm, v, tm = shared_pair(pairs, name, dp, **SMALL)
    check_forward_loss_grads(jm, v, tm, dp)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_round_trip_under_the_reference_names(name, pairs):
    jm, v, tm = shared_pair(pairs, name, supervised_dp(seed=1), **SMALL)
    name_map = (mappings.llunetpp_name_map() if name == "llunet++_re"
                else mappings.lllinet_name_map())
    check_round_trip(tm, v, name_map)
    keys = set(tm.module.state_dict())
    assert "conv0_4.conv1.weight" in keys and "final.weight" in keys
    assert ("trans.density_k" in keys) == (name == "lllinet_hvi")


@pytest.mark.parametrize("config, name", [("configs/llunetpp_re_lol_v1.py", "llunet++_re"),
                                          ("configs/lllinet_hvi_lol_v1.py", "lllinet_hvi")])
def test_config_trains_through_both_clis(config, name, tmp_path, monkeypatch):
    root = tmp_path / "data"
    fabricate(root, {f"lol_v1/{s}/{d}": rng for s in ("train", "test")
                     for d, rng in (("image", (0.0, 0.3)), ("ref", (0.2, 1.0)))})
    tiny_config(config, tmp_path / "tiny.py", {"filters": SMALL["filters"]},
                data_cfg={"batch_size": 2})
    jrun, prun, got = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                    supervised_dp(n=2))
    assert got == name
    # LLUNet++'s conv1 feeds an instance norm: its bias has no gradient but
    # rounding; 2 steps of Adam at the config's lr 1e-5
    assert_clis_agree(jrun, prun, name, reach=(r"conv\d_\d\.conv1\.bias", 2 * 2 * 1e-5))


@pytest.mark.parametrize("name, canonical", [("llunet++_re", "llunet++_re"),
                                             ("llunetpp_re", "llunet++_re"),
                                             ("llunetpp", "llunet++_re"),
                                             ("llunet++", "llunet++_re"),
                                             ("lllinet", "lllinet"),
                                             ("lllinet_hvi", "lllinet_hvi")])
def test_registry_entries_as_jax(name, canonical):
    jm, tm = jax_build_model(name), build_model(name, device="cpu")
    assert tm.name == jm.name == canonical
    for attr in ("arch", "tasks", "schemes", "required_inputs", "size_divisor"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
