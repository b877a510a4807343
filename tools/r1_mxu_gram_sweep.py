"""R1-mxu's bf16 gram against chip_smoke.py's bound, over many draws.

    python tools/r1_mxu_gram_sweep.py [--seeds 200] [--shape 1,1,37,384] [--heads 8]
                                      [--device cuda|cpu] [--root TREE] [--qk]

For each seed, a RestormerBlock of width C (torch seeded with it, then
``chip_smoke.draw_restormer`` from a numpy generator of the same seed) and
x ~ U(-1, 1) in bfloat16, as ``chip_smoke.py`` phase 3 draws them. Three
grams of R1 with the taps folded (``dw_mxu``) are compared:

- ``plain``: ``r1_mxu_plain``, q and k summed in float32 (K = 9C) and then
  rounded to bf16, as the TPU kernel rounds them;
- ``witness``: ``r1_mxu_witness_gram``, the same function with the
  LayerNorm and q and k computed in float64 before the same roundings;
- ``kernel``: ``r1_mxu_apply`` (on a CUDA device only).

Each pair is given as max|d| over chip_smoke.py's bound for the bf16 gram,
1e-3 x max|ref|. Where plain against witness also goes over 1, the bound is
narrower than float32 arithmetic allows; the kernel is held to the plain version's own accuracy (no more draws over the bound
against the witness, by no larger a factor). Prints one JSON line a seed,
then a summary line: the largest ratio of each pair and how many seeds went
over.

On the card, ``--root TREE`` takes the kernel source of another checkout
(an unpacked ``git archive`` of the parent, say) and builds it under
``TREE/build/r1_mxu_sweep/``. ``--qk`` builds an instrumented copy of that
source whose folded R1 also writes each pixel's LayerNorm row (the bf16
operand of the product) and its q and k in float32, before they are
rounded for the gram; each seed's line then adds how many of the kernel's
and of the plain version's LayerNorm values round to another bf16 than
the float64 LayerNorm does (``ln_bf16_diffs``) and, for the kernel's q and
k and for the plain version's float32 product of the same operands, max|d|
against the float64 sum of those operands (over max|ref|) and how many
values round to another bf16 than the float64 sum does. The package's own
source and build are not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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

# the instrumented copy: two device pointers the folded R1 writes through
# when they are set (LayerNorm rows (N, H, W, C); q and k (N, H, W, 2, C)).
# The bf16 form's FOLD branch (r1_bf16_kernel): the LayerNorm tile after it
# is computed, q and k where they are rounded for the gram.
PRELUDE = "__device__ float* rb_dbg_ln;\n__device__ float* rb_dbg_qk;\n"
LN_ANCHOR_B = "      // (the first step's barrier puts the LayerNorm before the product)\n"
LN_DUMP_B = """      if (rb_dbg_ln) {
        __syncthreads();
        for (int e = tid; e < PH * C; e += kThreadsB) {
          const int m = e / C, c = e - m * C;
          const int gh = h0 - 1 + m / HW2, gw = w0 - 1 + m % HW2;
          if (gh >= 0 && gh < H && gw >= 0 && gw < W)
            rb_dbg_ln[((static_cast<int64_t>(n) * H + gh) * W + gw) * C + c] =
                __bfloat162float(ln[m * LDA + c]);
        }
      }
"""
QK_ANCHOR_B = """            *reinterpret_cast<uint32_t*>(dst + m * LDQ + ch0 + 8 * j + 2 * t4) =
                bf16x2_bits(a0, a1);
"""
QK_DUMP_B = """            if (rb_dbg_qk && in) {
              float* d = rb_dbg_qk +
                         ((static_cast<int64_t>(n) * H + h0 + m / TW) * W + w0 + m % TW) * 2 * C +
                         grp * C + hh * HD + ch0 + 8 * j + 2 * t4;
              d[0] = a0;
              d[1] = a1;
            }
"""
# the general form's bf16 path (r1_kernel<T, C, HEADS, FOLD>), for older trees
LN_ANCHOR = r"ln_store<T, C, NV(?:, FOLD)?>\(xv, p\.ln_w, p\.ln_b, dst\);"
LN_DUMP = """
      if (FOLD && rb_dbg_ln) {
        __syncwarp();
        for (int c = lane; c < C; c += 32)
          rb_dbg_ln[((static_cast<int64_t>(n) * H + gh) * W + gw) * C + c] = dst[c];
      }"""
QK_ANCHOR = ("StoreImage<T, TW>{v + static_cast<int64_t>(n) * H * W * C + hh * HD, C, px});\n"
             "      __syncthreads();")
QK_DUMP = """
      if (rb_dbg_qk) {
        for (int e = tid; e < P * HD; e += kThreads) {
          const int m = e / HD, j = e - m * HD;
          if (!px.inside(m)) continue;
          float* d = rb_dbg_qk + (static_cast<int64_t>(n) * H * W + px.index(m)) * 2 * C + hh * HD + j;
          d[0] = qs[m * G::LDQ + j];
          d[C] = ks[m * G::LDQ + j];
        }
      }"""
EPILOGUE = """
extern "C" int rb_dbg_set(void* ln, void* qk) {
  cudaError_t e = cudaMemcpyToSymbol(rb_dbg_ln, &ln, sizeof(ln));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(rb_dbg_qk, &qk, sizeof(qk));
  return static_cast<int>(e);
}
"""


def instrument(src: str) -> str:
    """The kernel source with the LayerNorm and q/k dumps; raises where the
    source lacks what is patched."""
    if src.count(LN_ANCHOR_B) == 1 and src.count(QK_ANCHOR_B) == 1:
        src = src.replace(LN_ANCHOR_B, LN_DUMP_B + LN_ANCHOR_B)
        src = src.replace(QK_ANCHOR_B, QK_ANCHOR_B + QK_DUMP_B)
    elif len(re.findall(LN_ANCHOR, src)) == 1 and src.count(QK_ANCHOR) == 1:
        src = re.sub(LN_ANCHOR, lambda m: m.group(0) + LN_DUMP, src)
        src = src.replace(QK_ANCHOR, QK_ANCHOR + QK_DUMP)
    else:
        raise ValueError("the source does not hold R1's LayerNorm call and folded "
                         "product once each")
    head = src.index("namespace {")
    return src[:head] + PRELUDE + src[head:] + EPILOGUE


def folded_qk(y: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """q and k (..., 2C) of the folded product of the operand ``y`` (the LN
    rows, bf16 values), summed in ``dtype``."""
    c = y.shape[-1]
    wf = rb._folded(p, "attn.qkv.weight", "attn.qkv_dwconv.weight")[:, :2 * c]
    t = F.pad(y.to(wf.dtype).to(dtype), (0, 0, 0, 0, 1, 1))
    return rb.dw9_inputs(t) @ wf.to(dtype)


def ln_of(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """R1's LayerNorm computed in ``dtype`` and rounded (through float32)
    to bf16, the product's operand."""
    w, b = p["norm1.body.weight"].to(dtype), p["norm1.body.bias"].to(dtype)
    return layer_norm(x.to(dtype), w, b, rb.LN_EPS).float().to(torch.bfloat16)


def ratio(a: torch.Tensor, ref: torch.Tensor) -> float:
    return (a - ref).abs().max().item() / (TOL_SUMS_BF16 * ref.abs().max().item())


def qk_error(qk: torch.Tensor, ref: torch.Tensor) -> dict:
    """max|d| over max|ref| and the values whose bf16 rounding differs."""
    d = (qk.double() - ref).abs().max().item() / ref.abs().max().item()
    flips = (qk.to(torch.bfloat16) != ref.to(torch.bfloat16)).sum().item()
    return {"rel": d, "bf16_flips": flips}


def load_tree(root: Path, qk: bool):
    """Point the package's build at (an instrumented copy of) ``root``'s
    kernel source and return its library."""
    from enhax_torch.kernels import _build
    out = root / "build" / "r1_mxu_sweep" / ("qk" if qk else "plain")
    out.mkdir(parents=True, exist_ok=True)
    src = (root / "enhax_torch" / "kernels" / "csrc" / "restormer_block.cu").read_text()
    (out / "restormer_block.cu").write_text(instrument(src) if qk else src)
    _build.CSRC, _build.BUILD_DIR = out, out / "kernels"
    rb._lib.cache_clear()
    return rb._lib()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--shape", default="1,1,37,384")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    ap.add_argument("--root", default=None)
    ap.add_argument("--qk", action="store_true")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = None
    if args.root or args.qk:
        if device.type != "cuda":
            raise SystemExit("--root and --qk build the kernel: they need a CUDA card")
        lib = load_tree(Path(args.root or Path(__file__).resolve().parents[1]).resolve(),
                        args.qk)
        if args.qk:
            lib.rb_dbg_set.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    worst: dict[str, float] = {}
    over: dict[str, int] = {}
    flips: dict[str, int] = {}
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        gen = np.random.default_rng(seed)
        blk = RestormerBlock(shape[-1], args.heads)
        draw_restormer(blk, gen)
        p = dict(blk.to(device, torch.bfloat16).named_parameters())
        x = torch.from_numpy(gen.uniform(-1, 1, shape).astype(np.float32))
        x = x.to(device, torch.bfloat16)
        row = {"seed": seed}
        with torch.inference_mode():
            grams = {"plain": rb.r1_mxu_plain(x, p)[1],
                     "witness": rb.r1_mxu_witness_gram(x, p)}
            if device.type == "cuda":
                if args.qk:
                    ln = torch.zeros(*shape, device=device)
                    qk = torch.zeros(*shape[:3], 2, shape[-1], device=device)
                    if lib.rb_dbg_set(ln.data_ptr(), qk.data_ptr()):
                        raise RuntimeError("rb_dbg_set failed")
                grams["kernel"] = rb.r1_mxu_apply(x, p)[1]
                if args.qk:
                    torch.cuda.synchronize()
                    lib.rb_dbg_set(None, None)
                    ref = folded_qk(ln, p, torch.float64)
                    lns = {name: ln_of(x, p, dt) for name, dt in
                           (("witness", torch.float64), ("plain", torch.float32))}
                    row["ln_bf16_diffs"] = {
                        "kernel": (ln.to(torch.bfloat16) != lns["witness"]).sum().item(),
                        "plain": (lns["plain"] != lns["witness"]).sum().item()}
                    for name, n in row["ln_bf16_diffs"].items():
                        flips[f"ln_{name}"] = flips.get(f"ln_{name}", 0) + n
                    found = {"kernel_qk": qk.reshape(ref.shape),
                             "plain_qk": folded_qk(ln, p, torch.float32)}
                    for name, val in found.items():
                        e = qk_error(val, ref)
                        row[name] = e
                        worst[name] = max(worst.get(name, 0.0), e["rel"])
                        flips[name] = flips.get(name, 0) + e["bf16_flips"]
        for a, b in (("plain", "witness"), ("kernel", "plain"), ("kernel", "witness")):
            if a in grams:
                r = ratio(grams[a], grams[b])
                row[f"{a}_vs_{b}"] = r
                worst[f"{a}_vs_{b}"] = max(worst.get(f"{a}_vs_{b}", 0.0), r)
                over[f"{a}_vs_{b}"] = over.get(f"{a}_vs_{b}", 0) + (r > 1)
        print(json.dumps(row))
    summary = {"shape": list(shape), "heads": args.heads, "device": str(device),
               "root": args.root, "seeds": args.seeds,
               "worst_ratio": worst, "seeds_over_bound": over}
    if args.qk:
        summary["qk_bf16_flips"] = flips
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
