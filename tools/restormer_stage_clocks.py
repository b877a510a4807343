"""Split R1's and R2's time on the card into the stages between their barriers.

    python tools/restormer_stage_clocks.py [--root TREE] [--level dec0] [--dtype bfloat16]

Takes ``enhax_torch/kernels/csrc/restormer_block.cu`` of the checkout
``TREE`` (default: this one) and writes an instrumented copy under
``TREE/build/stage_clocks/``, which it builds and loads in place of the
package's library; the package's own source is not touched. In the
instrumented copy thread 0 of every block of each RestormerBlock kernel
(``r1_kernel``, ``r2_kernel`` and their bf16 forms, where the source has
them) reads ``clock64()`` after each ``__syncthreads()`` and adds
the cycles since its previous reading to a counter of that barrier (a
"site": the barriers in source order), and the cycles from its last
barrier to the end of the kernel to a last one. A site inside a loop sums
its iterations. The cycles a stage takes are those of its slowest warp, as
the barrier waits for it. Prints the card's name and power limit, each
kernel's CUDA-event time with the counters on, and one JSON line a site
that ran: its line in the source, the code just before the barrier, its
cycles summed over all blocks, its share, and that share of the kernel's
time. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from restormer_levels import LEVELS, block_params  # noqa: E402

KERNEL_NAMES = r"__global__[^;{]*?\b(r[12]_\w*kernel)\s*\("   # r1_kernel, r2_bf16_kernel, ...
MAX_KERNELS = 4
SITES = 64
PRELUDE = """
__device__ unsigned long long rb_stage_cycles[%d][%d];
#define RB_STAMP(K, S)                                                   \\
  if (threadIdx.x == 0) {                                                \\
    const long long rb_now = clock64();                                  \\
    atomicAdd(&rb_stage_cycles[K][S], (unsigned long long)(rb_now - rb_clk)); \\
    rb_clk = rb_now;                                                     \\
  }
""" % (MAX_KERNELS, SITES)
EPILOGUE = """
extern "C" int rb_stage_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, rb_stage_cycles, sizeof(rb_stage_cycles)));
}
extern "C" int rb_stage_reset() {
  static unsigned long long zero[%d][%d] = {};
  return static_cast<int>(cudaMemcpyToSymbol(rb_stage_cycles, zero, sizeof(zero)));
}
""" % (MAX_KERNELS, SITES)


def body_span(src: str, name: str) -> tuple[int, int]:
    """The offsets of the braces that open and close kernel ``name``'s body."""
    m = re.search(r"__global__[^;{]*?\b%s\s*\(" % name, src)
    if m is None:
        raise ValueError(f"no kernel {name} in the source")
    start = src.index("{", m.end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return start, i
    raise ValueError(f"unbalanced braces in {name}")


def kernels(src: str) -> list[str]:
    """The RestormerBlock kernels of the source (r1_kernel, r2_kernel and
    any other form), in source order."""
    return list(dict.fromkeys(re.findall(KERNEL_NAMES, src)))[:MAX_KERNELS]


def instrument(src: str) -> tuple[str, dict]:
    """The source with a stamp after every barrier of its RestormerBlock
    kernels, and for each (kernel, site) its line and the code before it."""
    labels = {}
    names = kernels(src)
    for k, name in enumerate(names):   # lines of the source as it is
        start, end = body_span(src, name)
        body = src[start + 1:end]
        line0 = src[:start].count("\n") + 1
        syncs = list(re.finditer(r"__syncthreads\(\);", body))
        for site, m in enumerate(syncs):
            before = [ln.strip() for ln in body[:m.start()].splitlines() if ln.strip()]
            labels[(k, site)] = {"line": line0 + body[:m.start()].count("\n"),
                                 "before": " | ".join(before[-2:])}
        labels[(k, len(syncs))] = {"line": line0 + body.count("\n"), "before": "end of kernel"}
    for k, name in enumerate(names):
        start, end = body_span(src, name)
        body = src[start + 1:end]
        pieces, site, pos = [], 0, 0
        for m in re.finditer(r"__syncthreads\(\);", body):
            pieces.append(body[pos:m.end()] + f" RB_STAMP({k}, {site});")
            pos, site = m.end(), site + 1
        new = ("\n  long long rb_clk = clock64();" + "".join(pieces) + body[pos:]
               + f"\n  RB_STAMP({k}, {site});\n")
        src = src[:start + 1] + new + src[end:]
    head = src.index("namespace {")
    return src[:head] + PRELUDE + src[head:] + EPILOGUE, labels


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--level", default="dec0", choices=[lv[0] for lv in LEVELS])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from enhax_torch.kernels import _build
    from enhax_torch.kernels import restormer_block as rb
    from enhax_torch.probes import cuda_ms
    stage_dir = root / "build" / "stage_clocks"
    stage_dir.mkdir(parents=True, exist_ok=True)
    original = (_build.CSRC / "restormer_block.cu").read_text()
    names = kernels(original)
    src, labels = instrument(original)
    (stage_dir / "restormer_block.cu").write_text(src)
    _build.CSRC, _build.BUILD_DIR = stage_dir, stage_dir / "kernels"
    lib = rb._lib()
    lib.rb_stage_read.argtypes = [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    level, shape, heads = next(lv for lv in LEVELS if lv[0] == args.level)
    dtype = getattr(torch, args.dtype)
    p = block_params(shape[-1], heads, dtype, seed=1)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32))
    x = x.to("cuda", dtype)
    with torch.inference_mode():
        v, gram, qss, kss = rb.r1_plain(x, p)
        attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], dtype)
        calls = (lambda: rb.r1_apply(x, p), lambda: rb.r2_apply(x, v, attn, p))
        times = [cuda_ms(fn, iters=args.iters) for fn in calls]
        if lib.rb_stage_reset():
            raise RuntimeError("rb_stage_reset failed")
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * (MAX_KERNELS * SITES))()
    if lib.rb_stage_read(cycles):
        raise RuntimeError("rb_stage_read failed")
    design = rb.design(1 if dtype == torch.bfloat16 else 0, shape[-1], heads) \
        if hasattr(rb, "design") else {}
    for k, name in enumerate(names):
        row = list(cycles[k * SITES:(k + 1) * SITES])
        total = sum(row)
        if not total:
            continue   # not the form this width and dtype run
        ms = times[0] if name.startswith("r1") else times[1]
        print(json.dumps({"kernel": name, "level": level, "shape": list(shape), "heads": heads,
                          "dtype": args.dtype, "forms": design, "ms": ms, "cycles": total}))
        for site, c in enumerate(row):
            if c:
                print(json.dumps({"kernel": name, "site": site, **labels[(k, site)],
                                  "cycles": c, "share": c / total, "ms": ms * c / total}))


if __name__ == "__main__":
    main()
