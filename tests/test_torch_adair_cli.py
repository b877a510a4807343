"""Port parity on the CPU: AdaIR (``adair``, at ``tests/test_torch_adair.py``'s
narrow width with ``fre_n`` 8 and numpy-drawn weights) served and trained
through both packages' entry points. A ragged request through both
``Predictor``s (padded to the divisor 8), in float32 within 1e-5 x max(1,
max|ref|) and in bf16 (the FFTs in float32 in both; the port's bf16 output
no further from its float32 than twice the JAX package's own gap). Two
train steps through both train CLIs on a config the test writes
(``rain13k`` pairs of 64x64, batches of two, Adam), in float32: the logged
losses and every parameter within 1e-5 x max(1, max|ref|). The JAX package's channel
attention has its norm's gradient at a zero vector set to 0, as torch's:
its own is NaN wherever a frequency box is empty, and fre1's always is
(``test_torch_adair.py::test_jax_gradient_is_nan_at_an_empty_box_and_the_ports_is_not``).
Apart from ``tests/test_torch_adair.py`` for tier-1's clock: the JAX
package's train step traces and compiles for 30-40 s, its two Predictors for
10-20 s.
"""

import numpy as np
import torch

from enhax.infer import Predictor as JaxPredictor
from enhax_torch.infer import Predictor
from test_torch_adair import SMALL, _dp, _pair, zero_grad_norm_at_zero  # noqa: F401
from torch_family_parity import assert_clis_agree, fabricate, run_both_clis, write_config
from torch_instance_parity import assert_close, pairs  # noqa: F401
from torch_threads import capped_torch_threads  # noqa: F401


def test_config_trains_through_both_clis(tmp_path, monkeypatch, pairs, zero_grad_norm_at_zero):
    root = tmp_path / "data"
    fabricate(root, {f"rain13k/{s}/{d}": (0.05, 0.95) for s in ("train", "test")
                     for d in ("image", "ref")}, hw=64)
    write_config(tmp_path / "tiny.py", "adair", SMALL, "rain13k", image_size=64)
    _, v, _, _ = _pair(pairs)
    jrun, prun, name = run_both_clis(tmp_path / "tiny.py", root, tmp_path, monkeypatch,
                                     _dp(1, n=2), variables=v)
    assert name == "adair"
    assert_clis_agree(jrun, prun, name)


def test_predictor_ragged_request_as_jax_in_float32_and_bf16(pairs):
    """37x45 padded to 40x48: fre3 on 20x24 (h // 8 = 2, w // 8 = 3)."""
    jm, v, tm, _ = _pair(pairs)
    x = _dp(5, hw=45)["image"][:, :37]
    outs = {}
    for bf16 in (False, True):
        ref = JaxPredictor(jm, variables=v, bf16=bf16).infer({"image": x})["enhanced"]
        out = Predictor(tm, device="cpu", bf16=bf16).infer({"image": x})["enhanced"]
        assert out.shape == x.shape and torch.isfinite(out).all()
        outs[bf16] = np.asarray(ref, np.float32), out.numpy()
    assert tm.size_divisor == jm.size_divisor == 8
    assert_close(outs[False][1], outs[False][0])
    jax_gap = np.abs(outs[True][0] - outs[False][0]).mean()
    port_gap = np.abs(outs[True][1] - outs[False][1]).mean()
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)
