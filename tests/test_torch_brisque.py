"""Port parity on the CPU: BRISQUE against the JAX package.

Three seeded draws of photo-like images (``test_torch_niqe.photo``, 200x296;
and one as a gray (H, W) image), the same arrays through
``enhax/nn/brisque.py`` (jitted) and ``enhax_torch/nn/brisque.py``:

  * ``brisque_features``: the ten shape parameters (the GGD's and each
    AGGD's alpha, at two scales) equal: both packages take scipy's float64
    tables cast to float32, so only the moment ratios' float32 roundings
    could part them, and on these draws none does; every other feature
    within 1e-4 x max(1, |ref|) (convolutions summed in other orders);
  * ``brisque`` without an SVM (the feature-norm proxy) within 1e-5 x
    max(1, |ref|), and with a synthetic libsvm model (40 support vectors
    drawn around the draws' features, the ranges from them) within 1e-4,
    against the JAX package's ``brisque`` jitted, as its features are: run
    eagerly (vmapped op by op) it takes the next grid point for the third
    draw's half-scale GGD alpha, a near tie its jitted run and the port
    resolve alike, and its proxy moves by 4.9e-4;
    ``brisque_score`` on the JAX package's own features within 1e-5;
  * the batch's mean over two images.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax_torch.constants import METRICS
from enhax_torch.nn import brisque as tb
from test_torch_niqe import photo
from torch_threads import capped_torch_threads  # noqa: F401

jb = importlib.import_module("enhax.nn.brisque")

ALPHAS = (0, 2, 6, 10, 14, 18, 20, 24, 28, 32)


def rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def draws():
    return [photo(s + 20) for s in range(3)]


def svm_for(feats: np.ndarray, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    lo, hi = feats.min(axis=0) - 0.1, feats.max(axis=0) + 0.1
    return {"sv": rng.uniform(-1, 1, (40, 36)), "coef": rng.normal(0, 1, 40),
            "rho": np.float64(0.3), "gamma": np.float64(0.05), "lo": lo, "hi": hi}


@pytest.mark.parametrize("case", range(3))
def test_features_match_jax(draws, case):
    x = draws[case] if case < 2 else draws[case].mean(axis=-1)   # the third as gray
    out = tb.brisque_features(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jb.brisque_features)(jnp.asarray(x)))
    assert out.shape == ref.shape == (36,)
    np.testing.assert_array_equal(out[list(ALPHAS)], ref[list(ALPHAS)])
    others = [c for c in range(36) if c not in ALPHAS]
    for c in others:
        assert abs(out[c] - ref[c]) <= 1e-4 * max(1.0, abs(ref[c])), (c, out[c], ref[c])


@pytest.mark.parametrize("case", range(3))
def test_scores_match_jax(draws, case):
    x = draws[case]
    feats = np.asarray(jax.jit(jb.brisque_features)(jnp.asarray(x)))
    svm = svm_for(np.stack([feats, feats * 1.1]), seed=case)
    jit_brisque = jax.jit(jb.brisque)
    assert rel(tb.brisque(torch.from_numpy(x)), jit_brisque(jnp.asarray(x))) <= 1e-5
    assert rel(tb.brisque(torch.from_numpy(x), svm=svm),
               jit_brisque(jnp.asarray(x), svm=svm)) <= 1e-4
    assert rel(tb.brisque_score(torch.from_numpy(feats), svm),
               jb.brisque_score(jnp.asarray(feats), svm)) <= 1e-5


def test_batch_mean_and_registry(draws):
    x = np.stack(draws[:2])
    out = METRICS.get("brisque")(torch.from_numpy(x))
    assert rel(out, jax.jit(jb.brisque)(jnp.asarray(x))) <= 1e-5
    each = [float(tb.brisque(torch.from_numpy(a))) for a in x]
    assert abs(float(out) - np.mean(each)) <= 1e-5 * max(1.0, abs(float(out)))
