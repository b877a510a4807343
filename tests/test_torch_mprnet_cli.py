"""Port parity on the CPU: MPRNet (``mprnet``, at ``tests/test_torch_mprnet.py``'s
narrow width and numpy-drawn weights) trained two steps through both train
CLIs on a config the test writes (``gopro`` pairs of 32x32, batches of
two, Adam), in float64: the logged losses and every parameter within 1e-5
x max(1, max|ref|). In its own file for tier-1's clock: the JAX package's
train step traces and compiles for 20-30 s.
"""

from test_torch_lllinet import supervised_dp
from test_torch_mprnet import SMALL, _pair
from torch_family_parity import assert_clis_agree, fabricate, run_both_clis, write_config
from torch_instance_parity import pairs  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


def test_config_trains_through_both_clis(tmp_path, monkeypatch, pairs):
    """In float64 (``x64``): in float32 a weight whose first gradient is
    within rounding of 0 takes Adam's +-lr step on the rounding's sign (one
    element of this narrow net parts by 3.2e-4 after two steps)."""
    root = tmp_path / "data"
    fabricate(root, {f"gopro/{s}/{d}": (0.05, 0.95) for s in ("train", "test")
                     for d in ("image", "ref")})
    write_config(tmp_path / "tiny.py", "mprnet", SMALL, "gopro")
    _, v, _ = _pair(pairs)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     supervised_dp(n=2), x64=True, variables=v)
    assert name == "mprnet"
    assert_clis_agree(jrun, prun, name)
