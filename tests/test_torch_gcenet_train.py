"""GCENet's shipped ``ulol`` configs through both train CLIs on the CPU.

``ulol`` is registered without depth maps in both packages (its
datapoints carry ``image`` alone), and ``gcenet``/``gcenet_zsn2n`` with
``use_depth`` require ``depth``: the JAX package's CLI raises
``KeyError: 'depth'`` on ``configs/gcenet_ulol.py`` and
``configs/gcenet_zsn2n_ulol.py`` as shipped, and the port's raises the
same. With ``use_depth`` off (edges from the grey image) both CLIs train
each config on a fabricated 2-image ``ulol`` tree at 32x32 (batch 2,
width 8) for 2 steps, from one init: losses and params within 1e-5 x
max(1, max|ref|), float32."""

import numpy as np
import pytest

from enhax.cli import train as jax_cli
from enhax_torch.cli import train as port_cli
from torch_family_parity import assert_clis_agree, fabricate, run_both_clis, tiny_config
from torch_threads import capped_torch_threads  # noqa: F401

CONFIGS = ["configs/gcenet_ulol.py", "configs/gcenet_zsn2n_ulol.py"]
SMALL = {"num_channels": 8, "num_iters": 4}


def _tree(root):
    # ulol gathers the test images of the unpaired sets and the splits of
    # the paired ones; two of its folders are enough
    fabricate(root, {"lol_v1/train/image": (0.0, 0.4), "lol_v1/test/image": (0.0, 0.4),
                     "dicm/test/image": (0.0, 0.4)}, n=1)


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_config_needs_depth_in_both_clis(config, tmp_path):
    _tree(tmp_path / "data")
    tiny_config(config, tmp_path / "tiny.py", SMALL, data_cfg={"batch_size": 2})
    argv = ["--config", str(tmp_path / "tiny.py"), "--root", str(tmp_path / "data"),
            "--steps", "2"]
    with pytest.raises(KeyError, match="depth"):
        jax_cli.train(jax_cli.parse_train_args(argv + ["--save-dir", str(tmp_path / "j")]))
    with pytest.raises(KeyError, match="depth"):
        port_cli.main(argv + ["--save-dir", str(tmp_path / "p"), "--device", "cpu"])


@pytest.mark.parametrize("config", CONFIGS)
def test_config_without_depth_trains_through_both_clis(config, tmp_path, monkeypatch):
    root = tmp_path / "data"
    _tree(root)
    tiny_config(config, tmp_path / "tiny.py", {**SMALL, "use_depth": False},
                data_cfg={"batch_size": 2})
    example = {"image": np.zeros((2, 32, 32, 3), np.float32)}
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     example)
    assert name in ("gcenet", "gcenet_zsn2n")
    assert_clis_agree(jrun, prun, name)
