"""Evaluation CLI: image-quality metrics over a folder of results.

Port of ``enhax/cli/metric.py``: walk the result folder, match each result
to the target of the same stem, and print the mean of each metric over the
items it was computed on.

  * Full-reference metrics (``FR_METRICS``): ``psnr ssim ms_ssim mae mse
    rmse`` and the extended set of ``enhax_torch.nn.metrics_img`` (``uiqi
    vif scc spectral_angle_mapper ergas rase rmse_sw psnrb
    total_variation``), optionally after scaling each result to its
    target's gray mean (``--use-gt-mean``). Registry aliases are accepted
    (``sam``, ``peak_signal_noise_ratio``, ...).
  * No-reference metrics (``NR_METRICS``): ``niqe`` against the pristine
    statistics of ``--niqe-params`` (an official ``.mat``, BasicSR's
    ``niqe_pris_params.npz``, or an ``.npz`` of
    ``enhax_torch.nn.niqe.fit_niqe_params``; without it the CLI exits),
    ``brisque`` (the libsvm model parsed into ``--brisque-svm``'s ``.npz``:
    sv, coef, rho, gamma, lo, hi; without it the uncalibrated feature-norm
    proxy), and the proxies ``brightness contrast entropy``.
  * ``--task segment``: a confusion matrix over result / target label maps
    (``SEG_METRICS``: ``miou mpa pa fwiou``; default ``miou mpa``) with
    ``--seg-classes`` classes, or two after ``--seg-binarize T`` (grayscale,
    then > T); a result ``*_leftImg8bit`` matches the target
    ``*_gtFine_color`` (darkcityscapes), else the same stem.

Results that are not finite or whose shape is not their target's are
skipped and counted. Everything runs on ``--device`` (CUDA unless asked
otherwise); NIQE's official MVG statistics finish on the host in float64.

Usage:
    python -m enhax_torch.cli.metric --input run/predict/... --target data/lol_v1/test/ref \\
        --metric psnr --metric ssim [--use-gt-mean] [--save-csv scores.csv] [--device cuda]
    python -m enhax_torch.cli.metric --input OUT --metric niqe --niqe-params params.npz \\
        --metric brisque [--brisque-svm svm.npz]
    python -m enhax_torch.cli.metric --task segment --input PRED --target GT \\
        [--seg-classes 19 | --seg-binarize 0.49] [--metric miou --metric fwiou]
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

FR_METRICS = ("psnr", "ssim", "ms_ssim", "mae", "mse", "rmse",
              # the extended image set (enhax_torch.nn.metrics_img)
              "uiqi", "vif", "scc", "spectral_angle_mapper", "ergas",
              "rase", "rmse_sw", "psnrb", "total_variation")
NR_METRICS = ("brightness", "contrast", "entropy", "niqe", "brisque")
# in-house proxies with no counterpart in the reference's pyiqa surface,
# labelled as such in the table
PROXY_METRICS = ("brightness", "contrast", "entropy")
SEG_METRICS = ("miou", "mpa", "pa", "fwiou")


def parse_metric_args(argv=None) -> dict:
    p = argparse.ArgumentParser("enhax-torch-metric")
    p.add_argument("--input", type=str, required=True, help="result image dir")
    p.add_argument("--target", type=str, default=None, help="GT image dir (FR metrics)")
    p.add_argument("--metric", action="append", default=None,
                   help="metric name; repeatable; default: psnr ssim")
    p.add_argument("--use-gt-mean", action="store_true",
                   help="scale results to GT mean brightness before FR metrics")
    p.add_argument("--niqe-params", type=str, default=None,
                   help="pristine stats for --metric niqe: official .mat or .npz, or an .npz "
                        "from enhax_torch.nn.niqe.fit_niqe_params")
    p.add_argument("--brisque-svm", type=str, default=None,
                   help="parsed libsvm BRISQUE model (.npz: sv/coef/rho/gamma/lo/hi); without "
                        "it brisque reports the uncalibrated feature-norm proxy")
    p.add_argument("--save-csv", type=str, default=None,
                   help="also write per-image scores to this CSV file")
    p.add_argument("--backend", type=str, default="torch",
                   help="accepted as the JAX CLI accepts it; the port computes in torch")
    p.add_argument("--task", choices=["enhance", "segment"], default="enhance",
                   help="segment = confusion-matrix mIoU/mPA over label maps")
    p.add_argument("--seg-classes", type=int, default=19,
                   help="number of segmentation classes (cityscapes: 19)")
    p.add_argument("--seg-binarize", type=float, default=None,
                   help="threshold in [0,1]: grayscale and binarize the label maps first")
    p.add_argument("--verbose", action="store_true",
                   help="accepted as the JAX CLI accepts it; prints nothing more")
    p.add_argument("--device", type=str, default="cuda")
    return vars(p.parse_args(argv))


def _nr_metrics(img: torch.Tensor) -> dict:
    """Brightness (gray mean), contrast (gray std) and the entropy of the
    gray level's 256-bin histogram over [0, 1], as ``jnp.histogram`` bins
    (right-open bins, the last closed)."""
    from enhax_torch.ops.color import rgb_to_grayscale
    g = rgb_to_grayscale(img).flatten()
    edges = torch.linspace(0.0, 1.0, 257, device=g.device)
    idx = torch.searchsorted(edges, g, right=True)
    idx = torch.where(g == edges[-1], 256, idx)
    hist = torch.bincount(idx, minlength=258)[1:257].float()
    p = hist / hist.sum().clamp_min(1)
    entropy = -torch.where(p > 0, p * torch.log2(p.clamp_min(1e-12)), 0.0).sum()
    return {"brightness": g.mean().item(), "contrast": g.std(correction=0).item(),
            "entropy": entropy.item()}


def _canonical(name: str) -> str:
    from enhax_torch.nn import brisque, metrics, metrics_img, niqe  # noqa: F401  (registers)
    try:
        return metrics.METRICS.canonical_name(name)
    except KeyError:
        return name


def _print_table(title: str, rows: list) -> None:
    print(title)
    print(f"{'metric':<24} {'value':>12} {'items':>6}")
    for label, value, items in rows:
        print(f"{label:<24} {value:>12} {items:>6}")


def _read_labels(path, binarize: float | None) -> np.ndarray:
    """A label map: an image of integer class ids, or with ``binarize`` its
    BT.601 gray level thresholded to {0, 1}."""
    from enhax_torch.ops.io import read_image
    img = np.asarray(read_image(path))
    if binarize is not None:
        g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
             if img.ndim == 3 and img.shape[-1] == 3 else img[..., 0]
             if img.ndim == 3 else img)
        return (g > binarize).astype(np.int64)
    # read_image scales to [0, 1]: back to integer class ids
    lab = np.round(img * 255.0).astype(np.int64)
    return lab[..., 0] if lab.ndim == 3 else lab


def measure_segment_metric(args: dict) -> dict:
    """A folder's segmentation scores: one confusion matrix over every
    result / target pair of label maps."""
    from enhax_torch.data.dataset import image_files
    from enhax_torch.models.base import resolve_device
    from enhax_torch.nn.metrics import SegmentationMetric

    if not args.get("target"):
        raise SystemExit("--task segment needs --target (GT label dir)")
    input_dir = Path(args["input"])
    binarize = args.get("seg_binarize")
    num_class = 2 if binarize is not None else int(args.get("seg_classes", 19))
    targets = {f.stem: f for f in image_files(args["target"])}
    files = image_files(input_dir)
    if not files:
        raise SystemExit(f"no images under {input_dir}")
    sm = SegmentationMetric(num_class, device=resolve_device(args.get("device", "cuda")))
    n = 0
    for f in files:
        tf = targets.get(f.stem.replace("_leftImg8bit", "_gtFine_color")) or targets.get(f.stem)
        if tf is None:
            continue
        pred = _read_labels(f, binarize)
        tgt = _read_labels(tf, binarize)
        if pred.shape != tgt.shape:
            continue
        sm.add_batch(torch.from_numpy(pred), torch.from_numpy(tgt))
        n += 1
    if n == 0:
        raise SystemExit("no result/GT pairs matched by stem")
    results = {"miou": sm.mean_iou(), "mpa": sm.mean_pixel_accuracy(),
               "pa": sm.pixel_accuracy(), "fwiou": sm.frequency_weighted_iou()}
    names = args.get("metric") or ["miou", "mpa"]
    unknown = [m for m in names if m not in results]
    if unknown:
        raise SystemExit(f"unknown metric {unknown[0]!r} for --task segment; "
                         f"choose from {sorted(results)}")
    results = {m: results[m] for m in names}
    _print_table(f"{input_dir} (segment, {num_class} classes)",
                 [(m, f"{v:.6f}", n) for m, v in results.items()])
    return results


def measure_metric(args: dict) -> dict:
    from enhax_torch.data.dataset import image_files
    from enhax_torch.models.base import resolve_device
    from enhax_torch.nn.metrics import METRICS
    from enhax_torch.ops.io import read_image
    from enhax_torch.ops.photometry import scale_gt_mean

    names = [_canonical(m) for m in args.get("metric") or ["psnr", "ssim"]]
    for m in names:
        if m not in FR_METRICS and m not in NR_METRICS:
            raise SystemExit(f"unknown metric {m!r}; FR: {FR_METRICS} NR: {NR_METRICS}")
    device = resolve_device(args.get("device", "cuda"))
    use_gt_mean = bool(args.get("use_gt_mean"))

    brisque_svm = None
    if "brisque" in names and args.get("brisque_svm"):
        with np.load(args["brisque_svm"]) as z:
            brisque_svm = {k: z[k] for k in ("sv", "coef", "rho", "gamma", "lo", "hi")}
    niqe_fn = None
    if "niqe" in names:
        from enhax_torch.nn.niqe import load_niqe_params, make_niqe
        if not args.get("niqe_params"):
            raise SystemExit("--metric niqe needs --niqe-params (.mat/.npz)")
        # every layout: official params score through the official pipeline
        niqe_fn = make_niqe(load_niqe_params(args["niqe_params"]))

    input_dir = Path(args["input"])
    files = image_files(input_dir)
    if not files:
        raise SystemExit(f"no images under {input_dir}")
    targets = {f.stem: f for f in image_files(args["target"])} if args.get("target") else {}

    sums = dict.fromkeys(names, 0.0)
    counts = dict.fromkeys(names, 0)
    rows_csv = []
    skipped = 0
    for f in files:
        img = torch.from_numpy(read_image(f)).to(device)
        if not torch.isfinite(img).all():
            skipped += 1
            continue
        tgt = None
        if f.stem in targets:
            tgt = torch.from_numpy(read_image(targets[f.stem])).to(device)
            if tgt.shape != img.shape:
                skipped += 1
                continue
            if use_gt_mean:
                img = scale_gt_mean(img, tgt)
        nr = None
        row = {"file": f.name}
        for m in names:
            if m in FR_METRICS:
                if tgt is None:
                    continue
                val = float(METRICS.get(m)(img[None], tgt[None]))
            elif m == "niqe":
                val = float(niqe_fn(img))
            elif m == "brisque":
                val = float(METRICS.get("brisque")(img, svm=brisque_svm))
            else:
                nr = nr or _nr_metrics(img)
                val = nr[m]
            sums[m] += val
            counts[m] += 1
            row[m] = f"{val:.6f}"
        rows_csv.append(row)

    results = {m: (sums[m] / counts[m] if counts[m] else float("nan")) for m in names}
    _print_table(f"{input_dir}" + (" (GT-mean)" if use_gt_mean else ""),
                 [(m + (" (proxy)" if m in PROXY_METRICS else ""), f"{v:.4f}", counts[m])
                  for m, v in results.items()])
    if any(m in PROXY_METRICS for m in names):
        print("[metric] (proxy) rows are enhax-only diagnostics, not comparable to the "
              "reference's pyiqa scores (use niqe/brisque with official params for those)")
    if skipped:
        print(f"[metric] skipped {skipped} items (NaN/shape mismatch/missing GT)")
    if args.get("save_csv"):
        with open(args["save_csv"], "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["file", *names])
            w.writeheader()
            w.writerows(rows_csv)
        print(f"[metric] per-image scores -> {args['save_csv']}")
    return results


def main(argv=None):
    args = parse_metric_args(argv)
    if args.get("task") == "segment":
        return measure_segment_metric(args)
    return measure_metric(args)


if __name__ == "__main__":
    main()
