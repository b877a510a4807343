"""Port parity: the probe kernels' plain versions against the JAX package, on
the CPU.

``dw3x3_plain`` against the JAX probe's depthwise 3x3 (``_dw3x3_valid`` over
the image as the probe's single row tile sees it: its first and last rows
repeated as the clamped halo rows, masked for ``rows="zero"``, left as they
are for ``rows="edge"``); ``gelu_plain`` with the A&S erf against
``_gelu_erf``, and with the rational erf against a numpy transcription of
``run/probe_gelu_kernel.py:56-69`` and against float64 ``scipy.special.erf``.
The probe entry points import here and raise without a card; nothing on the
CPU moves a launch count. Tolerances: 1e-6 (float32), 2^-8 relative for a
bfloat16 dw output (one bf16 rounding of values summed in another order);
the A&S GELU on each side within GELU_ULPS float32 ULPs of |x| of the same
formula in float64, and the port within twice that of JAX.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from enhax.kernels import restormer_block as jrb
from enhax_torch.kernels import dw3x3, gelu
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-6


def probe_tile_dw(x: np.ndarray, k: np.ndarray, rows: str) -> np.ndarray:
    """The JAX probe's dw over one row tile of each image: the clamped halo
    rows are the first and last rows, masked unless ``rows == "edge"``."""
    h = x.shape[1]
    out = []
    for img in x:
        y = jnp.concatenate([img[:1], img, img[-1:]], axis=0)
        row = jnp.arange(h + 2).reshape(-1, 1, 1)
        mask = ((row == 0) | (row == h + 1)) & (rows == "zero")
        out.append(jrb._dw3x3_valid(y, jnp.asarray(k), h, mask))
    return np.stack([np.asarray(o) for o in out])


@pytest.mark.parametrize("rows", dw3x3.ROWS)
@pytest.mark.parametrize("shape", [(2, 9, 13, 37), (1, 1, 7, 8), (1, 5, 1, 3)])
def test_dw3x3_plain_matches_jax_probe(rows, shape):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, shape[-1])).astype(np.float32)
    out = dw3x3.dw3x3_plain(torch.from_numpy(x), torch.from_numpy(k), rows)
    np.testing.assert_allclose(out.numpy(), probe_tile_dw(x, k, rows), atol=TOL, rtol=0)


def test_dw3x3_wrapper_bfloat16_on_cpu():
    """The wrapper takes the plain version on the CPU, in x's dtype, and the
    edge rows differ from the zero rows only in the first and last rows."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 6, 11, 16)).astype(np.float32)
    k = rng.uniform(-1, 1, (3, 3, 16)).astype(np.float32)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    zero = dw3x3.dw3x3_apply(xb, kb, rows="zero")
    edge = dw3x3.dw3x3_apply(xb, kb, rows="edge")
    assert zero.dtype == torch.bfloat16
    ref = probe_tile_dw(xb.float().numpy(), kb.float().numpy(), "zero")
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(zero.float().numpy() - ref).max()) <= 2.0 ** -8 * scale
    assert torch.equal(zero[:, 1:-1], edge[:, 1:-1])
    assert not torch.equal(zero[:, 0], edge[:, 0])
    assert dw3x3.dw3x3_apply.launches == 0


def test_dw3x3_wrapper_checks_its_inputs():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="rows"):
        dw3x3.dw3x3_apply(x, torch.zeros(3, 3, 8), rows="reflect")
    with pytest.raises(ValueError, match=r"\(3, 3, C\)"):
        dw3x3.dw3x3_apply(x, torch.zeros(3, 3, 7))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("c, dtype, aligned, path", [
    (8, BF16, True, "ring"), (8, BF16, False, "walk1"),
    (8, F32, True, "ring"), (8, F32, False, "walk1"),
    (36, BF16, True, "walk4"), (36, BF16, False, "walk1"),
    (36, F32, True, "ring"), (36, F32, False, "walk1"),
    (37, BF16, True, "walk1"), (37, BF16, False, "walk1"),
    (37, F32, True, "walk1"), (37, F32, False, "walk1"),
    (288, BF16, True, "ring"), (288, BF16, False, "walk1"),
    (288, F32, True, "ring"), (288, F32, False, "walk1"),
    (512, BF16, True, "ring"), (512, BF16, False, "walk1"),
    (512, F32, True, "ring"), (512, F32, False, "walk1"),
])
def test_dw3x3_path(c, dtype, aligned, path):
    """The ring takes rows of channels a multiple of 16 bytes at a 16-byte
    aligned base; the column walk the rest, 4 channels a thread where C is a
    multiple of 4 and x aligned to 4 elements. Misaligned: a base 2 elements
    into a 16-byte-aligned buffer."""
    size = torch.empty((), dtype=dtype).element_size()
    ptr = 4096 if aligned else 4096 + 2 * size
    assert dw3x3.dw3x3_path((2, 5, 7, c), dtype, ptr) == path


def test_probe_turns_spread():
    from enhax_torch.probes import spread
    assert spread([0.5, 0.3, 0.4, 0.9, 0.2]) == {"ms": 0.4, "ms_min": 0.2, "ms_max": 0.9}
    assert spread([2.0, 1.0], "library_ms") == {"library_ms": 1.5, "library_ms_min": 1.0,
                                                "library_ms_max": 2.0}


def gelu_grid() -> np.ndarray:
    return np.linspace(-6, 6, 20001, dtype=np.float32)


# Each float32 evaluation of the A&S GELU against the same formula in
# float64, in float32 ULPs of |x|: erf = 1 - P exp(-z^2) is held to a few
# ULPs of 1 (t, the Horner steps, exp and the subtraction, each a few
# roundings of values at most 1), and 0.5 x (1 + erf) scales that by |x|/2
# and rounds twice more: about 7.5 ULPs of |x| in all. Units of |x|, not of
# the output: for x < 0, 1 + erf cancels to a tiny output whose own ULPs say
# nothing of the arithmetic (|gelu(x)| <= |x|; for x >= 1 the two units
# agree within 2x). Measured on one host: 2.99 on both sides.
GELU_ULPS = 8.0


def gelu_as_float64(x: np.ndarray) -> np.ndarray:
    """The A&S GELU with the kernels' coefficients, evaluated in float64."""
    x = x.astype(np.float64)
    a = np.abs(x * 0.7071067811865476)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return 0.5 * x * (1.0 + np.sign(x) * (1.0 - poly * np.exp(-a * a)))


def ulps_of_x(out: np.ndarray, ref: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.abs(out.astype(np.float64) - ref.astype(np.float64)) / np.spacing(
        np.abs(x)).astype(np.float64)


def assert_within_ulps(name: str, out: np.ndarray, ref: np.ndarray, x: np.ndarray,
                       bound: float) -> None:
    u = ulps_of_x(out, ref, x)
    i = int(u.argmax())
    assert u[i] <= bound, (f"{name}: worst at x={x[i]!r}: {out[i]!r} against {ref[i]!r}, "
                           f"{u[i]:.3f} ULPs of |x| (bound {bound}); "
                           f"{int((u > bound).sum())} of {u.size} points over")


def test_gelu_as_matches_jax():
    """The port and JAX's ``_gelu_erf`` each within GELU_ULPS of the float64
    formula, and so within the sum of the two of each other (the host's
    vectorised exp may round otherwise on either side)."""
    x = gelu_grid()
    out = gelu.gelu_apply(torch.from_numpy(x), erf="as").numpy()
    ref_jax = np.asarray(jrb._gelu_erf(jnp.asarray(x)))
    ref64 = gelu_as_float64(x)
    assert_within_ulps("port vs float64", out, ref64, x, GELU_ULPS)
    assert_within_ulps("JAX vs float64", ref_jax, ref64, x, GELU_ULPS)
    assert_within_ulps("port vs JAX", out, ref_jax, x, 2 * GELU_ULPS)


def erf_rat_numpy(z: np.ndarray) -> np.ndarray:
    """run/probe_gelu_kernel.py:56-69 in numpy, float32 throughout."""
    f = np.float32
    z = np.clip(z, f(-4.0), f(4.0))
    s = z * z
    p = f(4.541595940311584e-06) + s * f(-1.2470351406334228e-08)
    p = f(0.00037391180030277586) + s * p
    p = f(0.0038262388474131987) + s * p
    p = f(0.05417170777013625) + s * p
    p = f(0.18505783362438136) + s * p
    p = f(1.1283791749554233) + s * p
    q = f(0.0012949563768775315) + s * f(6.173045363623838e-05)
    q = f(0.015397154870790184) + s * q
    q = f(0.11378662606783872) + s * q
    q = f(0.4973367187815083) + s * q
    return z * p / (f(1.0) + s * q)


def test_gelu_rational_matches_probe_and_exact_erf():
    x = gelu_grid()
    out = gelu.gelu_apply(torch.from_numpy(x), erf="rational").numpy()
    f = np.float32
    probe = f(0.5) * x * (f(1.0) + erf_rat_numpy(x * f(0.7071067811865476)))
    np.testing.assert_allclose(out, probe, atol=TOL, rtol=0)
    x64 = x.astype(np.float64)
    exact = 0.5 * x64 * (1.0 + scipy.special.erf(x64 / np.sqrt(2.0)))
    np.testing.assert_allclose(out, exact, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="erf"):
        gelu.gelu_apply(torch.from_numpy(x), erf="tanh")
    assert gelu.gelu_apply.launches == 0


@pytest.mark.parametrize("name", ["dw_mxu", "dw_roofline", "gelu_kernel"])
def test_probe_needs_a_card(name, monkeypatch):
    """Each probe imports on the CPU and refuses to time without a card."""
    probe = importlib.import_module(f"enhax_torch.probes.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
