"""Evaluation CLI: image-quality metrics over a folder of results.

Port of ``enhax/cli/metric.py``: walk the result folder, match each result
to the target of the same stem, compute the full-reference metrics
(``psnr ssim ms_ssim mae mse rmse``) and the no-reference proxies
(``brightness contrast entropy``), optionally after scaling each result to
its target's gray mean (``--use-gt-mean``), and print the mean of each
metric over the items it was computed on. Results that are not finite or
whose shape is not their target's are skipped and counted. The metrics run
on ``--device`` (CUDA unless asked otherwise).

Usage:
    python -m enhax_torch.cli.metric --input run/predict/... --target data/lol_v1/test/ref \
        --metric psnr --metric ssim [--use-gt-mean] [--save-csv scores.csv] [--device cuda]

Not ported yet (ROADMAP item 1.15), each raising ``NotImplementedError``:
the other metrics of the JAX CLI (the extended image set, ``niqe``,
``brisque``), ``--niqe-params``, ``--brisque-svm`` and ``--task segment``.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import torch

FR_METRICS = ("psnr", "ssim", "ms_ssim", "mae", "mse", "rmse")
# in-house proxies with no counterpart in the reference's pyiqa surface,
# labelled as such in the table
NR_METRICS = ("brightness", "contrast", "entropy")
# the JAX CLI's metrics that are not ported yet
NOT_PORTED = ("uiqi", "vif", "scc", "spectral_angle_mapper", "ergas", "rase", "rmse_sw",
              "psnrb", "total_variation", "niqe", "brisque")
_ITEM = "is not ported yet (ROADMAP item 1.15)"


def parse_metric_args(argv=None) -> dict:
    p = argparse.ArgumentParser("enhax-torch-metric")
    p.add_argument("--input", type=str, required=True, help="result image dir")
    p.add_argument("--target", type=str, default=None, help="GT image dir (FR metrics)")
    p.add_argument("--metric", action="append", default=None,
                   help="metric name; repeatable; default: psnr ssim")
    p.add_argument("--use-gt-mean", action="store_true",
                   help="scale results to GT mean brightness before FR metrics")
    p.add_argument("--save-csv", type=str, default=None,
                   help="also write per-image scores to this CSV file")
    p.add_argument("--niqe-params", type=str, default=None, help=f"NIQE {_ITEM}")
    p.add_argument("--brisque-svm", type=str, default=None, help=f"BRISQUE {_ITEM}")
    p.add_argument("--task", choices=["enhance", "segment"], default="enhance",
                   help=f"segment {_ITEM}")
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
    from enhax_torch.nn.metrics import METRICS
    try:
        return METRICS.canonical_name(name)
    except KeyError:
        return name


def measure_metric(args: dict) -> dict:
    from enhax_torch.data.dataset import image_files
    from enhax_torch.models.base import resolve_device
    from enhax_torch.nn.metrics import METRICS
    from enhax_torch.ops.io import read_image
    from enhax_torch.ops.photometry import scale_gt_mean

    if args.get("task", "enhance") != "enhance":
        raise NotImplementedError(f"--task {args['task']} {_ITEM}")
    for flag in ("niqe_params", "brisque_svm"):
        if args.get(flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} {_ITEM}")
    names = [_canonical(m) for m in args.get("metric") or ["psnr", "ssim"]]
    for m in names:
        if m in NOT_PORTED:
            raise NotImplementedError(f"metric {m!r} {_ITEM}")
        if m not in FR_METRICS and m not in NR_METRICS:
            raise SystemExit(f"unknown metric {m!r}; FR: {FR_METRICS} NR: {NR_METRICS}")
    device = resolve_device(args.get("device", "cuda"))
    use_gt_mean = bool(args.get("use_gt_mean"))

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
            else:
                nr = nr or _nr_metrics(img)
                val = nr[m]
            sums[m] += val
            counts[m] += 1
            row[m] = f"{val:.6f}"
        rows_csv.append(row)

    results = {m: (sums[m] / counts[m] if counts[m] else float("nan")) for m in names}
    print(f"{input_dir}" + (" (GT-mean)" if use_gt_mean else ""))
    print(f"{'metric':<20} {'value':>10} {'items':>6}")
    for m, v in results.items():
        label = m + (" (proxy)" if m in NR_METRICS else "")
        print(f"{label:<20} {v:>10.4f} {counts[m]:>6}")
    if any(m in NR_METRICS for m in names):
        print("[metric] (proxy) rows are enhax-only diagnostics, not comparable to the "
              "reference's pyiqa scores")
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
    return measure_metric(parse_metric_args(argv))


if __name__ == "__main__":
    main()
