"""Port parity on the CPU: the extended image metrics against the JAX package.

Every function of ``enhax_torch/nn/metrics_img.py`` on three seeded draws
(numpy, each a noisy copy of a random target; sizes large enough for VIF's
four scales), against ``enhax/nn/metrics_img.py`` on the same arrays, within
1e-5 x max(1, |ref|) (float32 sums in other orders): ``total_variation``
(its three reductions), ``spectral_angle_mapper``, ``ergas``, ``rase``,
``rmse_sw``, ``uiqi``, ``scc``, ``psnrb``, ``vif``, ``spectral_distortion_index``,
``spatial_distortion_index`` (with ``pan_lr`` pooled and given) and
``perceptual_path_length`` (lerp and slerp, "full" and "end" sampling, in
float64: the port reads the latents the JAX package draws from its key; the
distances, mean and std within 1e-9 x max(1, |ref|)); and every
name and alias resolves in both registries to the same canonical name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.constants import METRICS as JAX_METRICS
from enhax.nn import metrics_img as jm
from enhax_torch.constants import METRICS
from enhax_torch.nn import metrics_img as tm
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
# one shape for the three draws: the JAX package's jitted metrics compile once
SHAPE = (2, 64, 72, 3)


def assert_close(out, ref, tol=TOL):
    out, ref = float(out), float(ref)
    assert abs(out - ref) <= tol * max(1.0, abs(ref)), (out, ref)


def draw(case: int) -> tuple:
    rng = np.random.default_rng(100 + case)
    ref = rng.uniform(0.05, 0.95, SHAPE).astype(np.float32)
    x = np.clip(ref + rng.normal(0, 0.08, SHAPE), 0, 1).astype(np.float32)
    return x, ref


PAIRED = ["spectral_angle_mapper", "ergas", "rase", "rmse_sw", "uiqi", "scc", "psnrb", "vif",
          "spectral_distortion_index"]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("name", PAIRED)
def test_paired_metrics_match_jax(name, case):
    x, ref = draw(case)
    out = getattr(tm, name)(torch.from_numpy(x), torch.from_numpy(ref))
    assert_close(out, jax.jit(getattr(jm, name))(jnp.asarray(x), jnp.asarray(ref)))


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_total_variation_matches_jax(reduction, case):
    x, _ = draw(case)
    out = tm.total_variation(torch.from_numpy(x), reduction=reduction)
    ref = np.asarray(jax.jit(jm.total_variation, static_argnames="reduction")(
        jnp.asarray(x), reduction=reduction))
    assert out.shape == ref.shape
    for o, r in zip(np.atleast_1d(out.numpy()), np.atleast_1d(ref)):
        assert_close(o, r)


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("given_lr", [False, True])
def test_spatial_distortion_index_matches_jax(given_lr, case):
    """Predictions and the pan image at full size, the multispectral image
    at half; ``pan_lr`` average-pooled by default or given."""
    x, ref = draw(case)
    rng = np.random.default_rng(200 + case)
    pan = rng.uniform(0, 1, x.shape[:-1] + (1,)).astype(np.float32)
    n, h, w, c = ref.shape
    ms = ref[:, : h // 2 * 2, : w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))
    kw_t, kw_j = {}, {}
    if given_lr:
        lr = rng.uniform(0, 1, ms.shape[:-1] + (1,)).astype(np.float32)
        kw_t, kw_j = {"pan_lr": torch.from_numpy(lr)}, {"pan_lr": jnp.asarray(lr)}
    out = tm.spatial_distortion_index(torch.from_numpy(x), torch.from_numpy(ms),
                                      torch.from_numpy(pan), **kw_t)
    assert_close(out, jax.jit(jm.spatial_distortion_index)(jnp.asarray(x), jnp.asarray(ms),
                                                           jnp.asarray(pan), **kw_j))


@pytest.mark.parametrize("case, interpolation, sample_mode", [
    (0, "lerp", "full"), (1, "slerp", "full"), (2, "lerp", "end")])
def test_perceptual_path_length_matches_jax(case, interpolation, sample_mode):
    """A linear generator of 6x6x3 images and a per-sample mean squared
    distance; 40 samples in batches of 16, the JAX key's latents given to
    the port. Both in float64: a distance is the square of two images'
    difference at t and t + 1e-4, over 1e-8, which float32's roundings of
    the two images (~1e-7) move by ~1e-3."""
    z_size, n = 8, 40
    w = np.random.default_rng(300 + case).normal(0, 0.3, (z_size, 6 * 6 * 3))
    kw = dict(z_size=z_size, num_samples=n, batch_size=16, interpolation=interpolation,
              sample_mode=sample_mode)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(case)
        k0, k1, kt = jax.random.split(key, 3)
        latents = [np.asarray(a) for a in (
            jax.random.normal(k0, (n, z_size)), jax.random.normal(k1, (n, z_size)),
            jax.random.uniform(kt, (n, 1)))]
        ref = jm.perceptual_path_length(
            lambda z: jnp.tanh(z @ w).reshape(-1, 6, 6, 3),
            similarity=lambda a, b: ((a - b) ** 2).mean(axis=(1, 2, 3)), key=key, **kw)
    assert latents[0].dtype == np.float64
    wt = torch.from_numpy(w)
    out = tm.perceptual_path_length(lambda z: torch.tanh(z @ wt).reshape(-1, 6, 6, 3),
                                    similarity=lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3)),
                                    latents=latents, **kw)
    assert_close(out[0], ref[0], 1e-9)
    assert_close(out[1], ref[1], 1e-9)
    assert out[2].shape == ref[2].shape
    assert np.abs(out[2] - ref[2]).max() <= 1e-9 * max(1.0, float(np.abs(ref[2]).max()))


def test_perceptual_path_length_draws_from_its_seed():
    def gen(z):
        return torch.tanh(z[:, :3])[:, None, None, :].expand(-1, 2, 2, 3)

    def sim(a, b):
        return ((a - b) ** 2).mean(dim=(1, 2, 3))

    a = tm.perceptual_path_length(gen, 4, sim, num_samples=20, batch_size=8, seed=3)
    b = tm.perceptual_path_length(gen, 4, sim, num_samples=20, batch_size=8, seed=3)
    c = tm.perceptual_path_length(gen, 4, sim, num_samples=20, batch_size=8, seed=4)
    assert a[0] == b[0] and a[0] != c[0] and np.isfinite(a[0]) and a[2].shape == (20,)


@pytest.mark.parametrize("name", [
    "total_variation", "spectral_angle_mapper", "sam", "ergas",
    "error_relative_global_dimensionless_synthesis", "rase", "relative_average_spectral_error",
    "rmse_sw", "root_mean_squared_error_using_sliding_window", "uiqi",
    "universal_image_quality_index", "scc", "spatial_correlation_coefficient", "psnrb",
    "peak_signal_noise_ratio_with_blocked_effect", "vif", "visual_information_fidelity",
    "vifp", "spectral_distortion_index", "d_lambda", "spatial_distortion_index", "d_s",
    "perceptual_path_length", "ppl"])
def test_names_and_aliases_as_jax(name):
    canonical = JAX_METRICS.canonical_name(name)
    assert METRICS.canonical_name(name) == canonical
    assert METRICS.get(name) is getattr(tm, canonical)
