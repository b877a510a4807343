"""Time the bench shapes of a checkout on the card, through its own chip_smoke.py.

    python tools/bench_tree.py [--root TREE]

Imports ``chip_smoke`` from the checkout ``TREE`` (default: the one holding
this script), so that its own ``enhax_torch`` is timed, and runs its bench
phases: Zero-DCE++ at 48x1088x1920 uint8 (sf=8, bf16), NAFNet-TLC at
2x736x1280 in bf16 and float32, and the Restormer request of four
1088x1920 frames tiled 384 (overlap 32, chunks of 8, bf16), each with its
profiler table (the Restormer's and NAFNet's go to ``TREE/build/profiles``).
Pointing ``--root`` at an unpacked ``git archive`` of another commit times
that commit; running this script for two commits in turns (parent, change,
change, parent) compares them on one card. Prints the card's name and
power limit and, last, one JSON line of the readings. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    smoke = importlib.import_module("chip_smoke")
    smi, _ = smoke.phase_device()
    bench = {"root": root, "card": smi,
             "zero_dce++_re 48x1088x1920 bfloat16": smoke.phase_bench()}
    for dtype in (torch.bfloat16, torch.float32):
        bench[f"nafnet_local 2x736x1280 {str(dtype)[6:]}"] = smoke.phase_bench_nafnet(dtype)
    bench["restormer 4x1088x1920 tiled 384 bfloat16"] = smoke.phase_bench_restormer()
    print(json.dumps(bench))


if __name__ == "__main__":
    main()
