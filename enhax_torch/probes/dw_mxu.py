"""A/B of the fused RestormerBlock with each dw 3x3 folded into its 1x1.

The counterpart of ``run/probe_dw_mxu.py`` on the card: the block through
``restormer_block_fast(x, p, dw_mxu=False)`` (R1 -> glue -> R2: the 1x1s on
the tensor cores over a one-pixel halo, the taps on the FMA units) against
``dw_mxu=True`` (R1-mxu -> glue -> R2-mxu: one product with K = 9C a 1x1,
on the tile's own pixels), bf16, at the JAX probe's three shapes. Both
variants are timed with CUDA events, in turns, twice; each keeps its best.

    python -m enhax_torch.probes.dw_mxu [--iters 10]

Prints the card's name and power limit, then one JSON line a level.
"""

from __future__ import annotations

import json
import sys

import torch

from enhax_torch.kernels.restormer_block import restormer_block_fast
from enhax_torch.probes import arg, card, cuda_device, cuda_ms, uniform

# (shape, heads, level) as in run/probe_dw_mxu.py
SHAPES = (((15, 256, 256, 48), 1, "enc0"), ((15, 256, 256, 96), 1, "dec0"),
          ((15, 128, 128, 96), 2, "L2"))


def block_params(c: int, heads: int, device, dtype=torch.bfloat16, seed: int = 0) -> dict:
    """A RestormerBlock's params at its init (drawn from ``seed``), on ``device``."""
    from enhax_torch.models.multitask.restormer import RestormerBlock
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        blk = RestormerBlock(c, heads)
    return dict(blk.to(device, dtype).named_parameters())


def ab(shape, heads: int, level: str, device, iters: int = 10, reps: int = 2) -> dict:
    """Both forms of one block at ``shape``, in turns; the best of ``reps``."""
    x = uniform(0, shape, -1, 1, torch.bfloat16, device)
    p = block_params(shape[-1], heads, device)
    best = {}
    with torch.inference_mode():
        for _ in range(reps):
            for mxu in (False, True):
                ms = cuda_ms(lambda m=mxu: restormer_block_fast(x, p, dw_mxu=m), iters)
                best[mxu] = min(best.get(mxu, ms), ms)
    return {"level": level, "shape": list(shape), "heads": heads, "dw_ms": best[False],
            "mxu_ms": best[True], "speedup": best[False] / best[True]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = cuda_device()
    iters = int(arg(argv, "iters", "10"))
    print(card(), flush=True)
    for shape, heads, level in SHAPES:
        print(json.dumps(ab(shape, heads, level, device, iters)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
