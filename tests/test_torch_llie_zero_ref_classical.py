"""Port parity on the CPU: the parameter-free LIME / DUAL against the JAX
package on 32x32 to 48x48 (PIE, the resize, serving and the CLI:
``tests/test_torch_llie_zero_ref_pie.py``).

Tolerances. Where float32 is held to the JAX package's float64 run (its
module with its constants cast to float64, ``float64_constants``), the port
lies within max(1e-5, 4x the JAX package's own float32 gap from that run)
(``assert_witnessed``): LIME's affinity weights are ratios of small
differences and DUAL's Mertens weights normalise products of a Laplacian's
magnitude, both of which float32 rounds apart, so the JAX package's float32
output lies ~1.6e-5 from float64 (the port computes both weights in
float64: 2e-6-6e-6). LIME without DUAL
(``dual=False``) is also held to the JAX package's float32 within 1e-5. The BiCGStab solve (``exact=False``) is chaotic in float32 (the
affinity weights span about six orders of magnitude: the JAX package's own
float32 solve lies 0.02-0.09 from its float64 one here, and is NaN at
33x45), so it is held in float64: step for step to the JAX package's
iterates (1e-10), and a full solve where the system lets it converge to
the direct solve and to the JAX package's solve (within max(1e-6, 4x the
JAX package's float64 gap from the direct solve)).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.models.llie import classical as jc
from enhax_torch.models.llie import classical as tc
from torch_instance_parity import FACTOR, assert_close, assert_witnessed, jax_float64, rel_err
from torch_threads import capped_torch_threads  # noqa: F401


class _Float64Constants:
    """``jax.numpy`` whose ``asarray``/``array`` give float64 (complex128)
    for float32 (complex64): the JAX classical module builds its kernels and
    OTFs in float32, which a float64 run would mix with float64."""

    @staticmethod
    def _up(a):
        return a.astype({np.dtype(np.float32): jnp.float64,
                         np.dtype(np.complex64): jnp.complex128}.get(np.dtype(a.dtype), a.dtype))

    def asarray(self, a, dtype=None, **kw):
        return self._up(jnp.asarray(a, dtype=dtype, **kw))

    def array(self, a, dtype=None, **kw):
        return self._up(jnp.array(a, dtype=dtype, **kw))

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float64_constants():
    saved = jc.jnp
    jc.jnp = _Float64Constants()
    try:
        yield
    finally:
        jc.jnp = saved


def draw_images(n=1, h=32, w=32, seed=31):
    return np.random.default_rng(seed).uniform(0.02, 0.5, (n, h, w, 3)).astype(np.float32)


def witness64(module, x):
    with float64_constants():
        return jax_float64(lambda a: module.apply({}, a)["enhanced"], x)


@pytest.mark.parametrize("h, w", [(32, 32), (33, 45)])
def test_dual_exact_matches_jax(h, w):
    """DUAL with the host's direct solve (the default)."""
    x = draw_images(2, h, w)
    ref = jc.LIMEModule().apply({}, jnp.asarray(x))["enhanced"]
    with torch.no_grad():
        out = tc.LIMEModule()(torch.from_numpy(x))["enhanced"]
    assert_witnessed(out, ref, witness64(jc.LIMEModule(), x))


@pytest.mark.parametrize("h, w", [(32, 32), (33, 45)])
def test_lime_without_dual_matches_jax(h, w):
    x = draw_images(1, h, w, seed=32)
    ref = jc.LIMEModule(dual=False).apply({}, jnp.asarray(x))["enhanced"]
    with torch.no_grad():
        out = tc.LIMEModule(dual=False)(torch.from_numpy(x))["enhanced"]
    assert_close(out, ref)


@pytest.mark.parametrize("h, w", [(32, 32), (33, 45)])
def test_bicgstab_steps_match_jax_in_float64(h, w):
    """The refined illumination after 1, 2 and 4 BiCGStab steps in float64,
    both packages: step for step the same iterates (from ~5 steps on,
    float64 rounding amplified by the system's conditioning parts them, by
    up to 1e-2 over a full solve, as far as either lies from the direct
    solve)."""
    L = np.random.default_rng(33).uniform(0.02, 0.5, (h, w))
    for steps in (1, 2, 4):
        with float64_constants(), jax.enable_x64(True):
            ref = jax.jit(lambda a: jc.refine_illumination_lime(a, exact=False, cg_maxiter=steps))(
                jnp.asarray(L, jnp.float64))
        out = tc.refine_illumination_lime(torch.from_numpy(L), exact=False, cg_maxiter=steps)
        assert out.dtype == torch.float64
        assert_close(out, np.asarray(ref), 1e-10)


@pytest.mark.parametrize("seed", [34, 35])
def test_bicgstab_full_solve_in_float64_matches_jax(seed):
    """A full solve (tolerance 1e-6, at most 2000 steps) in float64 where
    the system lets BiCGStab converge (lambda 0.005: at the default 0.15 its
    condition number is ~1e7 and either package's solve may stop at a
    breakdown short of the direct solve): the port's illumination within
    max(1e-6, 4x the JAX package's float64 gap) of the direct solve and of
    the JAX package's solve. In float32 it is finite and within
    [eps^gamma, 1]."""
    L = np.random.default_rng(seed).uniform(0.02, 0.5, (40, 36))
    with float64_constants(), jax.enable_x64(True):
        ref, exact = (np.asarray(jax.jit(lambda a, e=e: jc.refine_illumination_lime(
            a, lambda_=0.005, exact=e))(jnp.asarray(L, jnp.float64))) for e in (False, True))
    out = tc.refine_illumination_lime(torch.from_numpy(L), lambda_=0.005, exact=False)
    bound = max(1e-6, FACTOR * rel_err(ref, exact))
    assert rel_err(out, exact) <= bound and rel_err(out, ref) <= bound
    out32 = tc.refine_illumination_lime(torch.from_numpy(L).float(), exact=False)
    assert torch.isfinite(out32).all()
    assert 1e-3 ** 0.6 - 1e-6 <= float(out32.min()) and float(out32.max()) <= 1.0


def test_mertens_fusion_matches_jax():
    rng = np.random.default_rng(37)
    ims = [rng.uniform(0, 1, (37, 29, 3)).astype(np.float32) for _ in range(3)]
    ref = jc.mertens_fusion([jnp.asarray(a) for a in ims])
    out = tc.mertens_fusion([torch.from_numpy(a) for a in ims])
    with float64_constants(), jax.enable_x64(True):
        w = np.asarray(jc.mertens_fusion([jnp.asarray(a, jnp.float64) for a in ims]))
    assert_witnessed(out, ref, w)
