"""Time the bench shapes and kernels of a checkout on the card, through its own chip_smoke.py.

    python tools/bench_tree.py [--root TREE] [--phases bench,timing] [--no-collect]

Imports ``chip_smoke`` from the checkout ``TREE`` (default: the one holding
this script), so that its own ``enhax_torch`` is timed, and runs its
phases:

- ``bench``: Zero-DCE++ at 48x1088x1920 uint8 (sf=8, bf16), NAFNet-TLC at
  2x736x1280 in bf16 and float32, and the Restormer request of four
  1088x1920 frames tiled 384 (overlap 32, chunks of 8, bf16), each with its
  profiler table (the Restormer's and NAFNet's go to ``TREE/build/profiles``;
  NAFNet's device time is read from its table's footer, so an older tree's
  batches get one too). A full collection of Python's garbage comes before
  each phase, as chip_smoke.py's ``main`` does, unless ``--no-collect``.
  Each phase's reading carries the collections that ran inside it (``gc``:
  count by generation, seconds): collected inside a timed loop, the
  earlier phases' garbage reads as host time.
- ``timing``: its probe phase, then its phase 7, each kernel by CUDA events
  at the main path's shapes against its bound and its plain version, as
  ``chip_smoke.py`` prints them.

Pointing ``--root`` at an unpacked ``git archive`` of another commit times
that commit; running this script for two commits in turns (parent, change,
change, parent) compares them on one card. Prints the card's name and
power limit and, last, one JSON line of the bench readings. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch


def device_ms(table: str) -> float:
    """The device time of a profiled batch from its profiler table's footer
    ("Self CUDA time total: ..."), in ms."""
    m = re.search(r"Self (?:CUDA|device) time total: ([\d.]+)(us|ms|s)\b", table)
    if m is None:
        raise ValueError("no device time total in the profiler table")
    return float(m.group(1)) * {"us": 1e-3, "ms": 1.0, "s": 1e3}[m.group(2)]


class Collections:
    """Python's garbage collections while it is entered: count by
    generation and seconds spent in them."""

    def __init__(self):
        self.counts, self.seconds, self._t0 = [0, 0, 0], 0.0, 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.counts[info["generation"]] += 1
            self.seconds += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def reading(self) -> dict:
        return {"by_generation": self.counts, "seconds": self.seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", default="bench")
    ap.add_argument("--no-collect", action="store_true")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    smoke = importlib.import_module("chip_smoke")
    smi, _ = smoke.phase_device()
    collect = (lambda: 0) if args.no_collect else gc.collect

    def run(phase, *a):
        collect()
        with Collections() as c:
            res = phase(*a)
        return {**res, "gc": c.reading()}

    bench = {"root": root, "card": smi, "collect": not args.no_collect}
    if "bench" in phases:
        bench["zero_dce++_re 48x1088x1920 bfloat16"] = run(smoke.phase_bench)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            res = run(smoke.phase_bench_nafnet, dtype)
            table = (Path(root) / "build" / "profiles" / f"profile_nafnet_{name}.txt").read_text()
            res["device_ms_table"] = device_ms(table)
            bench[f"nafnet_local 2x736x1280 {name}"] = res
        bench["restormer 4x1088x1920 tiled 384 bfloat16"] = run(smoke.phase_bench_restormer)
    if "timing" in phases:
        gen = np.random.default_rng(0)
        _, probes = smoke.phase_probes(gen)
        smoke.phase_timing(gen, probes)
    print(json.dumps(bench))


if __name__ == "__main__":
    main()
