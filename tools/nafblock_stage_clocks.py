"""Split K1's and K2's time on the card into the stages between their barriers.

    python tools/nafblock_stage_clocks.py [--root TREE] [--dtype bfloat16]

Takes ``enhax_torch/kernels/csrc/nafblock.cu`` of the checkout ``TREE``
(default: this one) and writes an instrumented copy under
``TREE/build/stage_clocks/``, which it builds and loads in place of the
package's library; the package's own source is not touched. In the
instrumented copy thread 0 of every block of each NAFBlock kernel
(``k1_kernel``, ``k2_kernel`` and their bf16 forms, where the source has
them) reads ``clock64()`` after each ``__syncthreads()``, ``__syncwarp()``
and ``NAF_STAGE()`` (an empty marker between the stages of a kernel whose
warps own their pixels and meet at no barrier) and adds the cycles since
its previous reading to a counter of that site (in source order), and the
cycles from its last site to the end of the kernel to a last one. A site
inside a loop sums its iterations. At a block barrier the cycles are those
of the block's slowest warp; at a warp's own sites, those of warp 0.

Runs K1 and K2 (the TLC local mean of K1's output as pooled) at the NAFNet
main path's two shapes, (2, 736, 1280, 32) and (2, 368, 640, 64). Prints the
card's name and power limit, each kernel's CUDA-event time with the
counters on, and one JSON line a site that ran: its line in the source,
the code just before it, its cycles summed over all blocks, its share, and
that share of the kernel's time. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from restormer_stage_clocks import MAX_KERNELS, SITES, instrument, kernels  # noqa: E402

KERNEL_NAMES = r"__global__[^;{]*?\b(k[12]_\w*kernel)\s*\("   # k1_kernel, k2_bf16_kernel, ...
SYNC = r"__syncthreads\(\);|__syncwarp\(\);|NAF_STAGE\(\);"
SHAPES = ((2, 736, 1280, 32), (2, 368, 640, 64))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    smoke = importlib.import_module("chip_smoke")   # the tree's own NAFBlock draw
    from enhax_torch.kernels import _build, nafblock
    from enhax_torch.probes import cuda_ms
    stage_dir = root / "build" / "stage_clocks"
    stage_dir.mkdir(parents=True, exist_ok=True)
    original = (_build.CSRC / "nafblock.cu").read_text()
    names = kernels(original, KERNEL_NAMES)
    src, labels = instrument(original, KERNEL_NAMES, SYNC)
    (stage_dir / "nafblock.cu").write_text(src)
    _build.CSRC, _build.BUILD_DIR = stage_dir, stage_dir / "kernels"
    lib = nafblock._lib()
    lib.rb_stage_read.argtypes = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dtype = getattr(torch, args.dtype)
    for shape in SHAPES:
        c = shape[-1]
        p = smoke.block_params(c, dtype, np.random.default_rng(1))
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32))
        x = x.to("cuda", dtype)
        with torch.inference_mode():
            g = nafblock.k1_plain(x, p)
            pooled = nafblock.box_mean_fast(g, 128)
            calls = (lambda: nafblock.k1_apply(x, p), lambda: nafblock.k2_apply(x, g, pooled, p))
            times = [cuda_ms(fn, iters=args.iters) for fn in calls]
            if lib.rb_stage_reset():
                raise RuntimeError("rb_stage_reset failed")
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * (MAX_KERNELS * SITES))()
        if lib.rb_stage_read(cycles):
            raise RuntimeError("rb_stage_read failed")
        design = nafblock.design(c, dtype) if hasattr(nafblock, "design") else {}
        for k, name in enumerate(names):
            row = list(cycles[k * SITES:(k + 1) * SITES])
            total = sum(row)
            if not total:
                continue   # not the form this width and dtype run
            ms = times[0] if name.startswith("k1") else times[1]
            print(json.dumps({"kernel": name, "shape": list(shape), "dtype": args.dtype,
                              "forms": design, "ms": ms, "cycles": total}))
            for site, cyc in enumerate(row):
                if cyc:
                    print(json.dumps({"kernel": name, "site": site, **labels[(k, site)],
                                      "cycles": cyc, "share": cyc / total,
                                      "ms": ms * cyc / total}))


if __name__ == "__main__":
    main()
