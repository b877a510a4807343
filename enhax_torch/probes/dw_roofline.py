"""The depthwise 3x3 alone, against its byte bound and cuDNN.

The counterpart of ``run/probe_dw_roofline.py`` on the card: the dw-only
kernel (``kernels/dw3x3.py``) at the fused Restormer block's tap widths
(3C = 288 and 2h = 512 at dec0), bf16, (15, 256, 256, C). The JAX probe's
``dw_base`` and ``dw_fma`` compute one function (SAME zero padding,
``rows="zero"``); ``dw_nomask`` leaves the clamped halo rows unmasked
(``rows="edge"``). The variants are timed with CUDA events, in turns, twice;
each keeps its best. Beside ``rows="zero"``, ``library_ms`` times cuDNN's
depthwise conv, ``F.conv2d(groups=C, padding=1)`` on the same channels_last
tensor; ``rows="edge"`` has no single library call.

    python -m enhax_torch.probes.dw_roofline [--c 288,512] [--hw 256] [--b 15] [--iters 20]

Prints the card's name and power limit, then one JSON line a variant.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from enhax_torch.kernels.dw3x3 import dw3x3_apply
from enhax_torch.probes import HBM_BYTES_PER_S, arg, card, cuda_device, cuda_ms, uniform

VARIANTS = (("dw_base/dw_fma", "zero"), ("dw_nomask", "edge"))


def bound_ms(x: torch.Tensor, k: torch.Tensor) -> float:
    """x read once, the output written once, the taps read once, over the
    memory rate (18 flops an element are far below the f32 rate)."""
    nbytes = 2 * x.numel() * x.element_size() + k.numel() * k.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def cases(b: int, hw: int, c: int, device, iters: int = 20, reps: int = 2) -> list[dict]:
    x = uniform(0, (b, hw, hw, c), -1, 1, torch.bfloat16, device)
    k = uniform(1, (3, 3, c), -1, 1, torch.bfloat16, device)
    xc = x.permute(0, 3, 1, 2)                          # NCHW view, channels_last
    kc = k.permute(2, 0, 1).unsqueeze(1).contiguous()   # (C, 1, 3, 3)
    fns = {rows: (lambda r=rows: dw3x3_apply(x, k, r)) for _, rows in VARIANTS}
    fns["library"] = lambda: F.conv2d(xc, kc, padding=1, groups=c)
    best = {}
    with torch.inference_mode():
        for _ in range(reps):
            for key, fn in fns.items():
                ms = cuda_ms(fn, iters)
                best[key] = min(best.get(key, ms), ms)
    b_ms = bound_ms(x, k)
    return [{"c": c, "shape": [b, hw, hw, c], "variant": name, "rows": rows,
             "ms": best[rows], "bound_ms": b_ms, "share_of_bound": b_ms / best[rows],
             "library_ms": best["library"] if rows == "zero" else None}
            for name, rows in VARIANTS]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = cuda_device()
    hw = int(arg(argv, "hw", "256"))
    b = int(arg(argv, "b", "15"))
    cs = [int(v) for v in arg(argv, "c", "288,512").split(",")]
    iters = int(arg(argv, "iters", "20"))
    torch.backends.cudnn.allow_tf32 = False
    print(card(), flush=True)
    for c in cs:
        for row in cases(b, hw, c, device, iters):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
