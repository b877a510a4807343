"""Port parity on the CPU: AirNet (``airnet``, at ``tests/test_torch_airnet.py``'s
narrow width and numpy-drawn weights and statistics) trained two steps
through both train CLIs on a config the test writes (``sidd`` pairs of
24x24, batches of two, Adam): in float32 the logged losses, every parameter
and the running statistics (the JAX trainer's ``batch_stats``) within 1e-5
x max(1, max|ref|), the statistics moved by the batches; in bf16-mixed both
trainers normalise with the running statistics and leave them as they
were. In its own file for tier-1's clock: the JAX package's two train steps
trace and compile for 15-25 s each.
"""

import torch

from enhax_torch.convert.from_jax import jax_to_torch_state_dict
from test_torch_airnet import SMALL, STATS, _pair
from test_torch_lllinet import supervised_dp
from torch_family_parity import assert_clis_agree, fabricate, run_both_clis, write_config
from torch_instance_parity import flat_params, pairs  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


def _cli(tmp_path, monkeypatch, pairs, trainer_cfg=None):
    root = tmp_path / "data"
    fabricate(root, {f"sidd/{s}/{d}": (0.05, 0.95) for s in ("train", "test")
                     for d in ("image", "ref")}, hw=24)
    write_config(tmp_path / "tiny.py", "airnet", SMALL, "sidd", image_size=24,
                 trainer_cfg=trainer_cfg)
    _, v, _ = _pair(pairs)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     supervised_dp(hw=24, n=2), variables=v)
    assert name == "airnet"
    start = jax_to_torch_state_dict("airnet", flat_params(v))
    return jrun, prun, start


def test_config_trains_through_both_clis(tmp_path, monkeypatch, pairs):
    """float32: parameters and running statistics within 1e-5 x max(1,
    max|ref|) of the JAX trainer's after two steps, the statistics moved."""
    jrun, prun, start = _cli(tmp_path, monkeypatch, pairs)
    assert_clis_agree(jrun, prun, "airnet")
    for k in (k for k in start if k.endswith(STATS)):
        assert (prun[1][k] - start[k]).abs().max() > 1e-4, k


def test_bf16_mixed_trains_on_frozen_statistics_in_both_clis(tmp_path, monkeypatch, pairs):
    """bf16-mixed: both trainers normalise with the running statistics and
    leave them as they were; the logged losses agree to bf16's precision."""
    jrun, prun, start = _cli(tmp_path, monkeypatch, pairs, {"precision": "bf16-mixed"})
    (jlog, jflat), (plog, psd) = jrun, prun
    jstats = jax_to_torch_state_dict("airnet", jflat)
    for k in (k for k in start if k.endswith(STATS)):
        assert torch.equal(psd[k], start[k]), k
        assert torch.equal(jstats[k], start[k]), k
    losses = [(float(j["train/loss"]), float(p["train/loss"])) for j, p in zip(jlog, plog)
              if j.get("train/loss")]
    assert losses and all(abs(j - p) <= 1e-2 * max(1.0, abs(j)) for j, p in losses)
