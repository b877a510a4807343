"""Port parity: the rest of scoring and the metric CLI, on the CPU.

``ms_ssim`` (its levels trimmed to the image and the weights renormalised),
``mae``, ``mse``, ``rmse``, ``rgb_to_grayscale`` and ``scale_gt_mean``
against the JAX package on random pairs and on ``assets/golden``; the
metric CLI against the JAX CLI on the same folders (both FR metrics and
the NR proxies, with and without ``--use-gt-mean``, a result without a
target and one whose shape is not its target's), its CSV against the JAX
CLI's, its alias names, what it refuses, and the rest of the JAX CLI's
surface (each extended metric, NIQE with both params layouts and without
params, BRISQUE with and without an SVM, ``--task segment`` with classes
and binarized). Tolerance: 1e-5 x max(1,
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
# NIQE and BRISQUE look each patch's moment ratio up on a grid of shape
# parameters 0.001 apart, and 8-bit images put ratios at near ties of two
# grid points: the JAX CLI runs its metrics eagerly, and on the three PNGs of
# ``nr_folder`` its own eager and jitted NIQE features take neighbouring
# grid points and their mean scores part by 0.56%, the port's by 0.14% from
# the eager and 0.71% from the jitted (tests/test_torch_niqe.py holds the
# features themselves); its eager BRISQUE parts from its jitted by 5.6e-5,
# the port's from the jitted by 8.5e-8
TOL_NIQE = 2e-2
TOL_BRISQUE = 1e-3
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


@pytest.mark.parametrize("flags", [["--metric", "sharpness"]])
def test_metric_cli_refuses_what_is_not_there(folders, flags):
    res, tgt = folders
    with pytest.raises(SystemExit, match="unknown"):
        cli.main(["--input", str(res), "--target", str(tgt), "--device", "cpu", *flags])


# -- NIQE, BRISQUE, the extended metrics and --task segment through both CLIs ------

@pytest.fixture(scope="module")
def nr_folder(tmp_path_factory):
    """Three photo-like 8-bit PNGs of 200x296 (NIQE's 96-px patches), the
    pristine params fitted (by the port: both CLIs read the same files) to
    three others and written in both layouts, and a synthetic libsvm model
    around their features."""
    from enhax_torch.nn.brisque import brisque_features
    from enhax_torch.nn.niqe import _fspecial_gaussian_np, fit_niqe_params
    from test_torch_niqe import photo
    root = tmp_path_factory.mktemp("nr")
    (root / "res").mkdir()
    for i in range(3):
        cv2.imwrite(str(root / "res" / f"{i:02d}.png"),
                    (photo(40 + i)[..., ::-1] * 255).round().astype(np.uint8))
    fitted = fit_niqe_params([torch.from_numpy(photo(50 + i)) for i in range(3)])
    np.savez(root / "fitted.npz", mu=fitted["mu"], cov=fitted["cov"], impl="self")
    np.savez(root / "niqe_pris_params.npz", mu_pris_param=fitted["mu"][None].astype(np.float64),
             cov_pris_param=fitted["cov"].astype(np.float64) + 1e-3 * np.eye(36),
             gaussian_window=_fspecial_gaussian_np())
    feats = np.stack([brisque_features(torch.from_numpy(photo(50 + i))).numpy()
                      for i in range(3)])
    rng = np.random.default_rng(7)
    np.savez(root / "svm.npz", sv=rng.uniform(-1, 1, (40, 36)), coef=rng.normal(0, 1, 40),
             rho=np.float64(0.3), gamma=np.float64(0.05), lo=feats.min(0) - 0.1,
             hi=feats.max(0) + 0.1)
    return root


@pytest.fixture(scope="module")
def seg_folder(tmp_path_factory):
    """Result and target label maps: three pairs of class ids 0-5 (one pair
    under the darkcityscapes names ``*_leftImg8bit`` / ``*_gtFine_color``,
    one with ids past the class count), as gray PNGs; and three RGB pairs
    for ``--seg-binarize``."""
    root = tmp_path_factory.mktemp("seg")
    rng = np.random.default_rng(8)
    for d in ("pred", "gt", "pred_rgb", "gt_rgb"):
        (root / d).mkdir()
    names = [("a_leftImg8bit", "a_gtFine_color"), ("b", "b"), ("c", "c")]
    for k, (pn, gn) in enumerate(names):
        gt = rng.integers(0, 6 if k < 2 else 9, (48, 64)).astype(np.uint8)
        pred = np.where(rng.uniform(size=gt.shape) < 0.7, gt, rng.integers(0, 6, gt.shape))
        cv2.imwrite(str(root / "gt" / f"{gn}.png"), gt)
        cv2.imwrite(str(root / "pred" / f"{pn}.png"), pred.astype(np.uint8))
        g = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        p = np.clip(g.astype(int) + rng.integers(-60, 60, g.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / "gt_rgb" / f"{gn}.png"), g)
        cv2.imwrite(str(root / "pred_rgb" / f"{pn}.png"), p)
    return root


NEW_CASES = {
    **{m: ("fr", ["--metric", m]) for m in (
        "uiqi", "vif", "scc", "sam", "ergas", "rase", "rmse_sw", "psnrb", "total_variation")},
    "niqe_fitted_npz": ("nr", ["--metric", "niqe", "--niqe-params", "{nr}/fitted.npz"]),
    "niqe_official_npz": ("nr", ["--metric", "niqe", "--niqe-params",
                                 "{nr}/niqe_pris_params.npz"]),
    "brisque_svm": ("nr", ["--metric", "brisque", "--brisque-svm", "{nr}/svm.npz"]),
    "brisque_proxy": ("nr", ["--metric", "brisque", "--metric", "entropy"]),
    "segment_classes": ("seg", ["--task", "segment", "--seg-classes", "6", "--metric", "miou",
                                "--metric", "mpa", "--metric", "pa", "--metric", "fwiou"]),
    "segment_binarize": ("seg_rgb", ["--task", "segment", "--seg-binarize", "0.49"]),
    "niqe_without_params": ("nr", ["--metric", "niqe"]),
}


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_metric_cli_new_surface_matches_jax_cli(folders, nr_folder, seg_folder, case):
    """The CLI against the JAX CLI on the same folder and flags: each
    extended full-reference metric (the golden folders), NIQE with fitted
    and with BasicSR-layout params (the official pipeline), BRISQUE with a
    libsvm model and as its proxy (three 200x296 photo-like PNGs), ``--task
    segment`` with classes (the darkcityscapes stem rule, ids past the
    class count left out) and binarized, and NIQE without params (both
    exit). Each mean within 1e-5 x max(1, |ref|) (UIQI, whose c1 = c2 = 0
    gives 0/0 on a flat window, the same inf or nan where the JAX CLI's
    is not finite); segmentation's float64 counts within 1e-12; NIQE and
    BRISQUE as ``TOL_NIQE`` and ``TOL_BRISQUE`` state."""
    kind, flags = NEW_CASES[case]
    flags = [f.format(nr=nr_folder) for f in flags]
    if kind == "fr":
        base = ["--input", str(folders[0]), "--target", str(folders[1])]
    elif kind == "nr":
        base = ["--input", str(nr_folder / "res")]
    else:
        sub = "_rgb" if kind == "seg_rgb" else ""
        base = ["--input", str(seg_folder / f"pred{sub}"), "--target",
                str(seg_folder / f"gt{sub}")]
    argv = base + flags
    if case == "niqe_without_params":
        with pytest.raises(SystemExit, match="needs --niqe-params"):
            jax_cli.measure_metric(jax_cli.parse_metric_args(argv))
        with pytest.raises(SystemExit, match="needs --niqe-params"):
            cli.main(argv + ["--device", "cpu"])
        return
    jargs = jax_cli.parse_metric_args(argv)
    ref = (jax_cli.measure_segment_metric(jargs) if kind.startswith("seg")
           else jax_cli.measure_metric(jargs))
    out = cli.main(argv + ["--device", "cpu"])
    assert list(out) == list(ref) and len(out) >= 1
    tol = {"segment_classes": 1e-12, "segment_binarize": 1e-12, "niqe_fitted_npz": TOL_NIQE,
           "niqe_official_npz": TOL_NIQE, "brisque_svm": TOL_BRISQUE,
           "brisque_proxy": TOL_BRISQUE}.get(case, TOL)
    for k, v in ref.items():
        if np.isfinite(v):
            assert_close(out[k], v, tol)
        else:   # uiqi's 0/0 on flat windows: the same inf or nan in both
            assert out[k] == v or (np.isnan(out[k]) and np.isnan(v)), (k, out[k], v)
