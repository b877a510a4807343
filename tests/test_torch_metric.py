"""Port parity: the rest of scoring and the metric CLI, on the CPU.

``ms_ssim`` (its levels trimmed to the image and the weights renormalised),
``mae``, ``mse``, ``rmse``, ``rgb_to_grayscale`` and ``scale_gt_mean``
against the JAX package on random pairs and on ``assets/golden``; the
metric CLI against the JAX CLI on the same folders (both FR metrics and
the NR proxies, with and without ``--use-gt-mean``, a result without a
target and one whose shape is not its target's), its CSV against the JAX
CLI's, its alias names, and what it refuses. Tolerance: 1e-5 x max(1,
|ref|) for a metric (float32 sums in other orders); the CSV's values
within the same bound, its files and columns equal; after
``scale_gt_mean``, whose JAX gray means are less exact, as stated at
``TOL_GT_MEAN`` (the port's scaled image within 1e-6 of float64).
"""

import csv
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhax.cli import metric as jax_cli
from enhax.nn import metrics as jmetrics
from enhax.ops.color import rgb_to_grayscale as jax_gray
from enhax.ops.photometry import scale_gt_mean as jax_scale_gt_mean
from enhax_torch.cli import metric as cli
from enhax_torch.constants import METRICS
from enhax_torch.nn import metrics
from enhax_torch.ops.color import rgb_to_grayscale
from enhax_torch.ops.io import read_image
from enhax_torch.ops.photometry import scale_gt_mean
from torch_threads import capped_torch_threads  # noqa: F401

TOL = 1e-5
# scale_gt_mean: the JAX package's gray means are float32 sums over H x W
# (2e-6 off the float64 mean on assets/golden, where the port's are within
# 1e-7), so its scaled image is up to ~1e-5 off and a metric after it
# (PSNR moves 4.3 dB per unit of its mse's relative error) up to ~1e-4
TOL_GT_MEAN = 1e-5
TOL_CLI_GT_MEAN = 1e-4
GOLDEN = Path(__file__).resolve().parents[1] / "assets" / "golden"


def assert_close(out, ref, tol=TOL):
    out, ref = float(out), float(ref)
    assert abs(out - ref) <= tol * max(1.0, abs(ref)), (out, ref)


def pairs():
    """Random pairs (one large enough for all five MS-SSIM levels, one
    trimmed to two) and the golden set's."""
    rng = np.random.default_rng(0)
    out = []
    for shape in ((1, 180, 200, 3), (2, 48, 61, 3)):
        ref = rng.uniform(0, 1, shape).astype(np.float32)
        x = np.clip(ref + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        out.append((x, ref))
    names = sorted(p.name for p in (GOLDEN / "image").iterdir())
    x = np.stack([read_image(GOLDEN / "image" / n) for n in names])
    ref = np.stack([read_image(GOLDEN / "ref" / n) for n in names])
    out.append((x, ref))
    return out


@pytest.mark.parametrize("name", ["ms_ssim", "mae", "mse", "rmse"])
@pytest.mark.parametrize("case", range(3))
def test_metrics_match_jax(name, case):
    x, ref = pairs()[case]
    out = METRICS.get(name)(torch.from_numpy(x), torch.from_numpy(ref))
    assert_close(out, getattr(jmetrics, name)(jnp.asarray(x), jnp.asarray(ref)))


def test_ms_ssim_weights_and_aliases_match_jax():
    x, ref = pairs()[0]
    w = (0.5, 0.3, 0.2)
    assert_close(metrics.ms_ssim(torch.from_numpy(x), torch.from_numpy(ref), weights=w),
                 jmetrics.ms_ssim(jnp.asarray(x), jnp.asarray(ref), weights=w))
    for alias in ("multiscale_ssim", "multiscale_structural_similarity_index_measure"):
        assert METRICS.canonical_name(alias) == "ms_ssim"


@pytest.mark.parametrize("case", range(3))
def test_gray_and_scale_gt_mean_match_jax(case):
    x, ref = pairs()[case]
    np.testing.assert_allclose(rgb_to_grayscale(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gray(jnp.asarray(x))), atol=1e-6)
    out = scale_gt_mean(torch.from_numpy(x[0]), torch.from_numpy(ref[0])).numpy()
    w = np.array([0.299, 0.587, 0.114])
    exact = np.clip(x[0] * ((ref[0] @ w).mean() / (x[0] @ w).mean()), 0, 1)
    np.testing.assert_allclose(out, exact, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jax_scale_gt_mean(
        jnp.asarray(x[0]), jnp.asarray(ref[0]))), atol=TOL_GT_MEAN)


# -- the metric CLI ------------------------------------------------------------------

@pytest.fixture
def folders(tmp_path):
    """The golden results and targets, a darkened result (GT-mean has work
    to do), a result with no target and one whose target has another shape."""
    res, tgt = tmp_path / "res", tmp_path / "tgt"
    res.mkdir()
    tgt.mkdir()
    for p in sorted((GOLDEN / "image").iterdir()):
        img = cv2.imread(str(p))
        cv2.imwrite(str(res / p.name), img)
        cv2.imwrite(str(tgt / p.name), cv2.imread(str(GOLDEN / "ref" / p.name)))
    cv2.imwrite(str(res / "dark.png"), (cv2.imread(str(GOLDEN / "ref" / "00.png")) * 0.4)
                .astype(np.uint8))
    cv2.imwrite(str(tgt / "dark.png"), cv2.imread(str(GOLDEN / "ref" / "00.png")))
    cv2.imwrite(str(res / "alone.png"), cv2.imread(str(GOLDEN / "image" / "01.png")))
    cv2.imwrite(str(res / "odd.png"), cv2.imread(str(GOLDEN / "image" / "02.png"))[:40])
    cv2.imwrite(str(tgt / "odd.png"), cv2.imread(str(GOLDEN / "ref" / "02.png")))
    return res, tgt


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("gt_mean", [False, True])
def test_metric_cli_matches_jax_cli(folders, tmp_path, gt_mean, capsys):
    res, tgt = folders
    argv = ["--input", str(res), "--target", str(tgt)]
    for m in ("psnr", "structural_similarity_index_measure", "ms_ssim", "mae", "mse", "rmse",
              "brightness", "contrast", "entropy"):
        argv += ["--metric", m]
    if gt_mean:
        argv.append("--use-gt-mean")
    ref = jax_cli.measure_metric(jax_cli.parse_metric_args(
        argv + ["--save-csv", str(tmp_path / "jax.csv")]))
    out = cli.main(argv + ["--save-csv", str(tmp_path / "torch.csv"), "--device", "cpu"])
    assert list(out) == list(ref) and "ssim" in out
    tol = TOL_CLI_GT_MEAN if gt_mean else TOL
    for k, v in ref.items():
        assert_close(out[k], v, tol)
    printed = capsys.readouterr().out
    assert "skipped 1 items" in printed and ("(GT-mean)" in printed) == gt_mean
    ours, theirs = read_csv(tmp_path / "torch.csv"), read_csv(tmp_path / "jax.csv")
    assert [list(r) for r in ours] == [list(r) for r in theirs]
    assert [r["file"] for r in ours] == ["00.png", "01.png", "02.png", "03.png", "alone.png",
                                         "dark.png"]
    for a, b in zip(ours, theirs):
        assert {k for k, v in a.items() if v} == {k for k, v in b.items() if v}
        for k, v in b.items():
            if k != "file" and v:
                assert_close(a[k], v, tol)


def test_metric_cli_defaults_to_psnr_and_ssim_on_the_card(folders, monkeypatch):
    res, tgt = folders
    out = cli.main(["--input", str(res), "--target", str(tgt), "--device", "cpu"])
    assert list(out) == ["psnr", "ssim"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", str(res), "--target", str(tgt)])


@pytest.mark.parametrize("flags, err", [
    (["--metric", "niqe"], NotImplementedError),
    (["--metric", "vif"], NotImplementedError),
    (["--niqe-params", "p.npz"], NotImplementedError),
    (["--brisque-svm", "s.npz"], NotImplementedError),
    (["--task", "segment"], NotImplementedError),
    (["--metric", "sharpness"], SystemExit),
])
def test_metric_cli_refuses_what_is_not_there(folders, flags, err):
    res, tgt = folders
    with pytest.raises(err, match="1.15" if err is NotImplementedError else "unknown"):
        cli.main(["--input", str(res), "--target", str(tgt), "--device", "cpu", *flags])
