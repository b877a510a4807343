"""Time the RestormerBlock kernels R1 and R2 at the five levels on the card.

    python tools/restormer_levels.py [--root TREE] [--dtype bfloat16] [--iters 8]

Times ``r1_apply`` and ``r2_apply`` of the ``enhax_torch`` under ``TREE``
(default: the checkout holding this script) with CUDA events, at each
level's chunk shape on the tiled path (8 tiles of 384x384: enc0, dec0 and
refinement, enc1/dec1, enc2/dec2, the latent), R2 on the plain R1's v and
the glue's attention, as ``chip_smoke.py`` phase 7 does. Pointing ``--root``
at an unpacked ``git archive`` of another commit times that commit, so two
commits are compared on one card by running this script for each in
turns. Prints the card's name and power limit, then one JSON line a level:
the mean time of ``--iters`` launches after two warm-up launches, and,
where the tree's wrapper chooses R1's grid by ``r1_grid``, R1's blocks
against the blocks resident on the card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

LEVELS = (("enc0", (8, 384, 384, 48), 1), ("dec0", (8, 384, 384, 96), 1),
          ("enc1/dec1", (8, 192, 192, 96), 2), ("enc2/dec2", (8, 96, 96, 192), 4),
          ("latent", (8, 48, 48, 384), 8))


def block_params(c: int, heads: int, dtype, seed: int) -> dict:
    """A RestormerBlock's params on the card, temperature drawn in [0.5, 3]
    and the LayerNorms shifted by U(-0.2, 0.2)."""
    from enhax_torch.models.multitask.restormer import RestormerBlock
    gen = np.random.default_rng(seed)
    blk = RestormerBlock(c, heads)
    with torch.no_grad():
        for name, prm in blk.named_parameters():
            if name.endswith("temperature"):
                prm.copy_(torch.from_numpy(gen.uniform(0.5, 3.0, prm.shape).astype(np.float32)))
            elif ".body." in name:
                prm.add_(torch.from_numpy(gen.uniform(-0.2, 0.2, prm.shape).astype(np.float32)))
    return dict(blk.to("cuda", dtype).named_parameters())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from enhax_torch.kernels import restormer_block as rb
    from enhax_torch.probes import cuda_ms
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dtype = getattr(torch, args.dtype)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    gen = np.random.default_rng(0)
    for i, (level, shape, heads) in enumerate(LEVELS):
        b, h, w, c = shape
        p = block_params(c, heads, dtype, seed=i)
        x = torch.from_numpy(gen.uniform(-1, 1, shape).astype(np.float32)).to("cuda", dtype)
        row = {"root": root, "level": level, "shape": list(shape), "heads": heads,
               "dtype": args.dtype}
        with torch.inference_mode():
            v, gram, qss, kss = rb.r1_plain(x, p)
            attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], dtype)
            row["r1_ms"] = cuda_ms(lambda: rb.r1_apply(x, p), iters=args.iters)
            row["r2_ms"] = cuda_ms(lambda: rb.r2_apply(x, v, attn, p), iters=args.iters)
        if hasattr(rb, "r1_grid"):
            resident, tile = rb.r1_geometry(code, c, heads, False)
            splits = rb.r1_grid(resident, b, heads, rb.r1_tiles(h, w, tile))
            blocks = splits * b * heads
            row.update(r1_tile=list(tile), r1_blocks=blocks, r1_resident=resident,
                       r1_waves=-(-blocks // resident))
        if hasattr(rb, "design"):
            row["design"] = rb.design(code, c, heads)
        print(json.dumps(row), flush=True)
        del x, p, v, gram, qss, kss, attn
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
