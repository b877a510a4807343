"""R1-mxu's bf16 gram against chip_smoke.py's bound, over many draws.

    python tools/r1_mxu_gram_sweep.py [--seeds 200] [--shape 1,1,37,384] [--heads 8]
                                      [--device cuda|cpu]

For each seed, a RestormerBlock of width C (torch seeded with it, then
``chip_smoke.draw_restormer`` from a numpy generator of the same seed) and
x ~ U(-1, 1) in bfloat16, as ``chip_smoke.py`` phase 3 draws them. Three
grams of R1 with the taps folded (``dw_mxu``) are compared:

- ``plain``: ``r1_mxu_plain``, q and k summed in float32 (K = 9C) and then
  rounded to bf16, as the TPU kernel rounds them;
- ``witness``: the same function with q and k summed in float64 before the
  same rounding: another valid order of the float32 sum, closer to exact;
- ``kernel``: ``r1_mxu_apply`` (on a CUDA device only).

Each pair is given as max|d| over chip_smoke.py's bound for the bf16 gram,
1e-3 x max|ref|. Where plain against witness also goes over 1, the bound is
narrower than the rounding of q and k allows any float32 order, and the
kernel is not at fault for going over it. Prints one JSON line a seed, then
a summary line: the largest ratio of each pair and how many seeds went over.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import TOL_SUMS_BF16, draw_restormer  # noqa: E402
from enhax_torch.kernels import restormer_block as rb  # noqa: E402
from enhax_torch.models.multitask.restormer import RestormerBlock  # noqa: E402
from enhax_torch.nn.layers import layer_norm  # noqa: E402


def witness_gram(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``r1_mxu_plain``'s gram with the folded product summed in float64."""
    y = layer_norm(x.float(), p["norm1.body.weight"].float(), p["norm1.body.bias"].float(),
                   rb.LN_EPS)
    wf = rb._folded(p, "attn.qkv.weight", "attn.qkv_dwconv.weight")
    t = F.pad(y.to(wf.dtype).double(), (0, 0, 0, 0, 1, 1))
    qkv = (rb.dw9_inputs(t) @ wf.double()).float()
    return rb._r1_outputs(x, qkv, p)[1]


def ratio(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a - ref).abs().max().item() / (TOL_SUMS_BF16 * ref.abs().max().item())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--shape", default="1,1,37,384")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    worst: dict[str, float] = {}
    over: dict[str, int] = {}
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        gen = np.random.default_rng(seed)
        blk = RestormerBlock(shape[-1], args.heads)
        draw_restormer(blk, gen)
        p = dict(blk.to(device, torch.bfloat16).named_parameters())
        x = torch.from_numpy(gen.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(device, torch.bfloat16)
        with torch.inference_mode():
            grams = {"plain": rb.r1_mxu_plain(x, p)[1], "witness": witness_gram(x, p)}
            if device.type == "cuda":
                grams["kernel"] = rb.r1_mxu_apply(x, p)[1]
        row = {"seed": seed}
        for a, b in (("plain", "witness"), ("kernel", "plain"), ("kernel", "witness")):
            if a in grams:
                r = ratio(grams[a], grams[b])
                row[f"{a}_vs_{b}"] = r
                worst[f"{a}_vs_{b}"] = max(worst.get(f"{a}_vs_{b}", 0.0), r)
                over[f"{a}_vs_{b}"] = over.get(f"{a}_vs_{b}", 0) + (r > 1)
        print(json.dumps(row))
    print(json.dumps({"shape": list(shape), "heads": args.heads, "device": str(device),
                      "seeds": args.seeds, "worst_ratio": worst, "seeds_over_bound": over}))


if __name__ == "__main__":
    main()
