"""The exact GELU's two erf forms, alone and inside R2.

The counterpart of ``run/probe_gelu_kernel.py`` on the card. First the
standalone kernel (``kernels/gelu.py``) with the A&S erf and with the
rational erf over the probe's (15, 256, 256, 128) float32 array, uniform in
[-3, 3], beside ``F.gelu`` (``library_ms``), each against its byte bound.
Then the fused block's GDFN: the JAX probe swaps the erf inside its block;
the port's R2 has one erf (``erff``), so R2 is timed as it is at enc0 and
dec0, (15, 256, 256, C) bf16. All variants are timed with CUDA events, in
turns, twice; each keeps its best.

    python -m enhax_torch.probes.gelu_kernel [--iters 30]

Prints the card's name and power limit, then one JSON line a case.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from enhax_torch.kernels import restormer_block as rb
from enhax_torch.kernels.gelu import ERFS, gelu_apply
from enhax_torch.probes import HBM_BYTES_PER_S, arg, card, cuda_device, cuda_ms, uniform
from enhax_torch.probes.dw_mxu import block_params

SHAPE = (15, 256, 256, 128)                   # the GDFN hidden at the L1 serving shape
BLOCKS = (((15, 256, 256, 48), 1, "enc0"), ((15, 256, 256, 96), 1, "dec0"))


def standalone(device, shape=SHAPE, iters: int = 30, reps: int = 2) -> list[dict]:
    x = uniform(0, shape, -3, 3, torch.float32, device)
    fns = {erf: (lambda e=erf: gelu_apply(x, e)) for erf in ERFS}
    fns["library"] = lambda: F.gelu(x)
    best = {}
    with torch.inference_mode():
        for _ in range(reps):
            for key, fn in fns.items():
                ms = cuda_ms(fn, iters)
                best[key] = min(best.get(key, ms), ms)
    b_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    return [{"shape": list(shape), "erf": erf, "ms": best[erf], "bound_ms": b_ms,
             "share_of_bound": b_ms / best[erf], "library_ms": best["library"]}
            for erf in ERFS]


def fused(device, iters: int = 10, reps: int = 2) -> list[dict]:
    """R2 (its GELU on erff) at enc0 and dec0, after R1 and the glue."""
    rows = []
    with torch.inference_mode():
        for shape, heads, level in BLOCKS:
            x = uniform(1, shape, -1, 1, torch.bfloat16, device)
            p = block_params(shape[-1], heads, device)
            v, gram, qss, kss = rb.r1_apply(x, p)
            attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], x.dtype)
            ms = min(cuda_ms(lambda: rb.r2_apply(x, v, attn, p), iters) for _ in range(reps))
            rows.append({"level": level, "shape": list(shape), "kernel": "r2_apply",
                         "erf": "erff", "ms": ms})
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = cuda_device()
    iters = int(arg(argv, "iters", "30"))
    print(card(), flush=True)
    for row in standalone(device, iters=iters) + fused(device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
