"""Port parity on the CPU: NIQE against the JAX package.

Three seeded draws of photo-like images (a random 1/16-size image upsampled
bicubically, plus noise; 200x296, cropped to six 96-px patches at scale 1,
or with a border of 4 cropped first, to the same 192x288), the same
arrays through ``enhax/nn/niqe.py`` (jitted) and ``enhax_torch/nn/niqe.py``:

  * ``niqe_features``: the sharpness mask equal; each feature column within
    1e-4 x max(1, max|ref|) (the MSCN maps come from convolutions summed in
    other orders: the columns read up to 5.1e-5); the shape parameters
    (alpha, every fourth column from the AGGD fits and the GGD's first)
    equal, or one grid step (0.001) apart where a near tie is shown: the
    patch's moment ratio, recomputed in float64, lies within 2e-5 x the
    ratio of the midpoint between the two grid points' values in the JAX
    package's table (its float32 ``lgamma`` and torch's part by up to ~1e-5
    relative, and the ratios of the two packages' float32 maps by ~1e-5).
    An AGGD mean next to such an alpha moves with it and is not held at
    that patch.
  * ``fit_niqe_params`` on the three draws: mu and cov within 1e-4 x
    max(1, max|ref|); the self pipeline's score (``niqe``) with those
    params within 1e-3 x max(1, |ref|) (the float32 pseudo-inverse at the
    JAX package's cut-off amplifies the features' differences); the
    pseudo-inverse's cut-off against ``jnp.linalg.pinv``'s on a matrix
    with singular values on both sides of it.
  * ``niqe_official`` with official-layout params synthesised from stats
    fitted to the official features of four other draws and
    ``_fspecial_gaussian_np``'s window, at ``convert_to`` "y" and "gray"
    and with a border cropped: within 1e-2 x max(1, |ref|) of the JAX
    package's pipeline run in float64 on the same float32 gray image
    (``official_witness``), or within 4x the JAX package's own float32
    score's gap from it where that is larger. The official score has no
    sharpness mask to soften a feature's move: one block's shape parameter
    one grid step away at a near tie (the tables, as above) moved a score
    by 0.76% on these draws. In float32 the Y channel's local variance
    cancels (E[x^2] - mu^2, both ~4e4): the JAX package's float32 score lies
    up to 3.5e-3 from its float64 run (held under 1e-2, so the witness is
    the same function); the port takes its window moments in float64.
  * every loader: a fitted ``.npz`` with and without ``impl``, BasicSR's
    ``.npz`` layout, and ``.mat`` files in the three MATLAB layouts
    (``scipy.io.savemat``), each equal to the JAX package's load; the
    registry's ``niqe`` through ``ENHAX_NIQE_PARAMS``, and its refusal
    without params.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from enhax_torch.constants import METRICS
from enhax_torch.nn import niqe as tn
from enhax_torch.ops.resize import resize
from torch_threads import capped_torch_threads  # noqa: F401

jn = importlib.import_module("enhax.nn.niqe")   # enhax.nn's ``niqe`` is the function

TOL_FEAT = 1e-4
TOL_SCORE = 1e-3
JAX_GAP_MAX = 1e-2   # the JAX package's float32 score against its float64: the same function
FACTOR = 4.0         # the port within 4x the JAX package's own float32 gap, where larger
# the official score: a block's shape parameter one grid step away (a near
# tie, the tables' float32 lgamma) moves the score by up to 0.76% (measured)
TOL_OFFICIAL = 1e-2
ALPHA_STEP = 0.001
# feature columns of the GGD fit (alpha, sigma^2) and the four AGGD fits
# (alpha, mean, left^2, right^2) at each of the two scales
GGD_ALPHA = (0, 18)
AGGD_ALPHA = tuple(s + 2 + 4 * k for s in (0, 18) for k in range(4))


def photo(seed: int, h: int = 200, w: int = 296) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.uniform(0, 1, (1, 3, h // 16, w // 16)).astype(np.float32))
    up = torch.nn.functional.interpolate(base, size=(h, w), mode="bicubic",
                                         align_corners=False).clamp(0, 1)
    x = 0.1 + 0.8 * up[0].permute(1, 2, 0).numpy() + rng.normal(0, 0.02, (h, w, 3))
    return np.clip(x, 0, 1).astype(np.float32)


def rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def draws():
    return [photo(s) for s in range(3)]


@pytest.fixture(scope="module")
def fitted(draws):
    return (tn.fit_niqe_params([torch.from_numpy(x) for x in draws]),
            jn.fit_niqe_params([jnp.asarray(x) for x in draws]))


def ratios(x: np.ndarray, col: int) -> np.ndarray:
    """The moment ratio each patch's fit for feature column ``col`` looks
    up, in float64 from the port's MSCN map: the GGD's rho, or the AGGD's
    normalised rhat of the column's pair product."""
    gray = tn._to_gray(torch.from_numpy(x))
    patch = 96
    gray = gray[: gray.shape[0] // patch * patch, : gray.shape[1] // patch * patch]
    if col >= 18:
        gray = resize(gray[..., None], (gray.shape[0] // 2, gray.shape[1] // 2),
                      method="linear", antialias=True)[..., 0]
        patch //= 2
    mscn = tn._mscn(gray)[0].double()
    k = col % 18
    if k == 0:
        b = tn._patchify(mscn, patch)
        return ((b ** 2).mean(dim=(-2, -1)) / b.abs().mean(dim=(-2, -1)) ** 2).numpy()
    dy, dx = ((0, 1), (1, 0), (1, 1), (1, -1))[(k - 2) // 4]
    b = tn._patchify(mscn * torch.roll(mscn, shifts=(-dy, -dx), dims=(0, 1)), patch)
    ls = torch.sqrt((b.clamp_max(0) ** 2).sum(dim=(-2, -1)) / (b < 0).sum(dim=(-2, -1)))
    rs = torch.sqrt((b.clamp_min(0) ** 2).sum(dim=(-2, -1)) / (b > 0).sum(dim=(-2, -1)))
    g = ls / rs
    rhat = b.abs().mean(dim=(-2, -1)) ** 2 / (b ** 2).mean(dim=(-2, -1))
    return (rhat * (g ** 3 + 1) * (g + 1) / (g ** 2 + 1) ** 2).numpy()


@pytest.mark.parametrize("case", range(3))
def test_features_match_jax(draws, case):
    x = draws[case]
    jf, jw = (np.asarray(a) for a in jax.jit(jn.niqe_features)(jnp.asarray(x)))
    tf, tw = (a.numpy() for a in tn.niqe_features(torch.from_numpy(x)))
    assert tf.shape == jf.shape == (6, 36)
    np.testing.assert_array_equal(tw, jw)
    stepped = set()
    grid = np.asarray(jn._GAMMA_GRID)
    for col in GGD_ALPHA + AGGD_ALPHA:
        steps = np.abs(tf[:, col] - jf[:, col]) / ALPHA_STEP
        assert steps.max() <= 1.0 + 1e-3, (col, steps.max())
        for p in np.flatnonzero(steps > 1e-3):
            # a near tie: the ratio within 2e-5 x ratio of the midpoint
            # between the two grid points' table values
            table = np.asarray(jn._GGD_RHO if col in GGD_ALPHA else jn._AGGD_R, np.float64)
            i, j = (int(np.argmin(np.abs(grid - a))) for a in (jf[p, col], tf[p, col]))
            r = ratios(x, col)[p]
            assert abs(r - (table[i] + table[j]) / 2) <= 2e-5 * r, (col, p, r)
            if col in AGGD_ALPHA:
                stepped.add((p, col + 1))   # the mean moves with alpha
    for col in range(36):
        keep = [p for p in range(tf.shape[0]) if (p, col) not in stepped]
        if col not in GGD_ALPHA + AGGD_ALPHA:
            assert rel(tf[keep, col], jf[keep, col]) <= TOL_FEAT, col


def test_fit_niqe_params_matches_jax(fitted):
    ours, ref = fitted
    assert ours["impl"] == ref["impl"] == "self"
    assert rel(ours["mu"], ref["mu"]) <= TOL_FEAT
    assert rel(ours["cov"], ref["cov"]) <= TOL_FEAT


@pytest.mark.parametrize("case", range(3))
def test_self_pipeline_score_matches_jax(draws, fitted, case):
    ours, ref = fitted
    x = draws[case]
    out = float(tn.niqe(torch.from_numpy(x), ours))
    want = float(jn.niqe(jnp.asarray(x), ref))
    assert np.isfinite(out) and abs(out - want) <= TOL_SCORE * max(1.0, abs(want)), (out, want)


def test_pinv_cuts_where_jax_cuts():
    """Singular values of 1, 1.5e-4 and 1e-6 against the cut-off 10 x 36 x
    eps(float32) = 4.3e-5: the port keeps the second and drops the third,
    as ``jnp.linalg.pinv`` does (torch's default cut-off would keep it)."""
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(36, 36)))
    s = np.concatenate([[1.0, 1.5e-4, 1e-6], np.zeros(33)])
    a = ((q * s) @ q.T).astype(np.float32)
    out = torch.linalg.pinv(torch.from_numpy(a), rtol=tn._PINV_RTOL).numpy()
    ref = np.asarray(jnp.linalg.pinv(jnp.asarray(a)))
    assert rel(out, ref) <= 1e-3
    assert np.abs(out).max() < 1e5   # the 1e-6 direction dropped (1 / 1e-6 otherwise)


def official_witness(x: np.ndarray, params: dict, crop_border: int = 0,
                     convert_to: str = "y") -> float:
    """``niqe_official``'s score from the JAX package's own feature
    functions run in float64 (``jax.enable_x64``; its lookup tables stay
    float32) on the float32 gray image both packages take, finished as
    ``niqe_official`` finishes."""
    img = jnp.asarray(x)
    gray = np.asarray(jn._to_y_channel(img) if convert_to == "y" else
                      (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]) * 255.0)
    with jax.enable_x64(True):
        gray = jnp.asarray(gray, jnp.float64)
        if crop_border:
            gray = gray[crop_border:-crop_border, crop_border:-crop_border]
        gray = gray[: gray.shape[0] // 96 * 96, : gray.shape[1] // 96 * 96]
        win = jnp.asarray(params["gaussian_window"], jnp.float64)
        half = (gray[0::2, 0::2] + gray[0::2, 1::2] + gray[1::2, 0::2] + gray[1::2, 1::2]) / 4
        feats = np.concatenate([
            np.asarray(jn._official_scale_feats(jn._mscn_official(gray, win), 96)),
            np.asarray(jn._official_scale_feats(jn._mscn_official(half, win), 48))],
            axis=-1).astype(np.float64)
    good = feats[~np.isnan(feats).any(axis=1)]
    d = params["mu"] - np.nanmean(feats, axis=0)
    inv = np.linalg.pinv((params["cov"] + np.cov(good, rowvar=False)) / 2.0)
    return float(np.sqrt(max(d @ inv @ d, 0.0)))


@pytest.fixture(scope="module")
def official_params() -> dict:
    """Official-layout params fitted, as the official statistics are, to
    the official pipeline's features (nanmean and covariance, float64) of
    four other draws, with ``_fspecial_gaussian_np``'s window."""
    win = jn._fspecial_gaussian_np()
    feats = []
    for seed in range(10, 14):
        gray = jn._to_y_channel(jnp.asarray(photo(seed)))[:192, :288]
        half = (gray[0::2, 0::2] + gray[0::2, 1::2] + gray[1::2, 0::2] + gray[1::2, 1::2]) / 4
        w = jnp.asarray(win, jnp.float32)
        feats.append(np.concatenate([
            np.asarray(jn._official_scale_feats(jn._mscn_official(gray, w), 96)),
            np.asarray(jn._official_scale_feats(jn._mscn_official(half, w), 48))], axis=-1))
    feats = np.concatenate(feats).astype(np.float64)
    good = feats[~np.isnan(feats).any(axis=1)]
    return {"mu": np.nanmean(feats, axis=0), "cov": np.cov(good, rowvar=False),
            "impl": "official", "gaussian_window": win}


@pytest.mark.parametrize("case, kw", [(0, {}), (1, {"convert_to": "gray"}),
                                      (2, {"crop_border": 4})])
def test_official_pipeline_matches_jax(draws, official_params, case, kw):
    params = official_params
    x = draws[case]
    out = tn.niqe_official(torch.from_numpy(x), params, **kw)
    ref = jn.niqe_official(jnp.asarray(x), params, **kw)
    want = official_witness(x, params, **kw)
    scale = max(1.0, abs(want))
    gap = abs(ref - want)
    assert gap <= JAX_GAP_MAX * scale, (ref, want)
    assert np.isfinite(out) and abs(out - want) <= max(TOL_OFFICIAL * scale, FACTOR * gap), (
        out, want, ref)
    if not kw:   # niqe dispatches official params to the official pipeline in both
        assert float(tn.niqe(torch.from_numpy(x), params)) == float(np.float32(out))
        assert float(jn.niqe(jnp.asarray(x), params)) == float(np.float32(ref))


def test_fspecial_window_is_the_jax_package_s():
    np.testing.assert_array_equal(tn._fspecial_gaussian_np(), jn._fspecial_gaussian_np())
    np.testing.assert_array_equal(tn._fspecial_gaussian_np(5, 1.0),
                                  jn._fspecial_gaussian_np(5, 1.0))


def _same_params(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if k == "impl":
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("layout", ["fitted", "fitted_untagged", "basicsr_npz", "pop_mat",
                                    "prisparam_mat", "pris_param_mat_window"])
def test_loaders_match_jax(fitted, tmp_path, layout):
    ours, _ = fitted
    mu, cov, win = ours["mu"], ours["cov"], jn._fspecial_gaussian_np()
    if layout == "fitted":
        path = tmp_path / "p.npz"
        np.savez(path, mu=mu, cov=cov, impl="self")
    elif layout == "fitted_untagged":
        path = tmp_path / "p.npz"
        np.savez(path, mu=mu, cov=cov)
    elif layout == "basicsr_npz":
        path = tmp_path / "niqe_pris_params.npz"
        np.savez(path, mu_pris_param=mu[None].astype(np.float64),
                 cov_pris_param=cov.astype(np.float64), gaussian_window=win)
    else:
        path = tmp_path / "p.mat"
        keys = {"pop_mat": ("pop_mu", "pop_cov"), "prisparam_mat": ("mu_prisparam",
                                                                    "cov_prisparam"),
                "pris_param_mat_window": ("mu_pris_param", "cov_pris_param")}[layout]
        content = {keys[0]: mu[None].astype(np.float64), keys[1]: cov.astype(np.float64)}
        if layout == "pris_param_mat_window":
            content["gaussian_window"] = win
        scipy.io.savemat(path, content)
    out, ref = tn.load_niqe_params(path), jn.load_niqe_params(path)
    _same_params(out, ref)
    assert out["impl"] == ("self" if layout.startswith("fitted") else "official")


def test_load_refuses_a_mat_without_params(tmp_path):
    scipy.io.savemat(tmp_path / "x.mat", {"other": np.zeros(3)})
    with pytest.raises(KeyError, match="no NIQE params"):
        tn.load_niqe_params(tmp_path / "x.mat")


def test_registry_entry_reads_the_environment(draws, fitted, tmp_path, monkeypatch):
    ours, ref = fitted
    np.savez(tmp_path / "p.npz", mu=ours["mu"], cov=ours["cov"], impl="self")
    x = torch.from_numpy(draws[0])
    fn = METRICS.get("niqe")
    monkeypatch.delenv("ENHAX_NIQE_PARAMS", raising=False)
    with pytest.raises(ValueError, match="ENHAX_NIQE_PARAMS"):
        fn(x)
    monkeypatch.setenv("ENHAX_NIQE_PARAMS", str(tmp_path / "p.npz"))
    assert float(fn(x)) == float(tn.niqe(x, ours)) == float(tn.make_niqe(ours)(x, None))
    assert float(fn(x, params=ours)) == float(fn(x))


def test_too_small_an_image_raises():
    with pytest.raises(ValueError, match="too small"):
        tn.niqe_features(torch.zeros(64, 200, 3))
    with pytest.raises(ValueError, match="too small"):
        tn.niqe_official(torch.zeros(64, 200, 3), {"mu": np.zeros(36), "cov": np.eye(36)})
