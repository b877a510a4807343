"""The CPU's predict of a quality chain split by golden image across
processes: the wall time of each split (processes x torch threads), the
measurement behind ``chip_smoke.py``'s ``QUALITY_CPU_PARTS`` and
``QUALITY_CPU_THREADS``.

    python tools/quality_cpu_split.py [--chain colie_instance] \
        [--splits 1x8,4x2,4x1,2x4] [--out build/quality_cpu_split]

One line a split: processes, threads, wall time, exit codes, images written.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("quality-cpu-split")
    p.add_argument("--chain", default="colie_instance")
    p.add_argument("--splits", default="1x8,4x2,4x1,2x4")
    p.add_argument("--out", default=str(REPO / "build" / "quality_cpu_split"))
    a = p.parse_args(argv)
    for split in a.splits.split(","):
        procs, threads = (int(v) for v in split.split("x"))
        shutil.rmtree(a.out, ignore_errors=True)
        parts = [list(range(4))[i::procs] for i in range(procs)]
        t0 = time.perf_counter()
        ps = [subprocess.Popen([sys.executable, "-m", "enhax_torch.quality", "--chain", a.chain,
                                "--images", ",".join(map(str, part)), "--out-root", a.out,
                                "--device", "cpu", "--threads", str(threads)], cwd=REPO,
                               stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
              for part in parts]
        rcs = [proc.wait() for proc in ps]
        n = len(list((Path(a.out) / a.chain / "pred").glob("*.png")))
        print(f"{a.chain} split procs={procs} threads={threads} wall="
              f"{time.perf_counter() - t0:.1f} s rcs={rcs} images={n}", flush=True)


if __name__ == "__main__":
    main()
