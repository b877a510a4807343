"""Bytes and least time on an H100 of each TPU kernel of the repo, at the
shapes its path runs, for the PyTorch/CUDA port's kernel table.

    python tools/port_kernel_bounds.py

Bytes count each input read once and each output written once (params
included). Operations: matrix products at the dense bf16 tensor-core rate
(their operands are bf16 on the serving paths), elementwise work at the
float32 rate. The bound is the larger of bytes over the memory rate and
that operation time. Rows 1-4 repeat what ``chip_smoke.py`` computes from
its own inputs; rows 5-8 are still to port, at the shapes named below.
Pure arithmetic: it imports nothing and needs no card.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet
HBM = 3.35e12
F32 = 67e12
BF16_TC = 989e12


def bound(nbytes: float, ew_flops: float, mm_flops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM * 1e3
    t_ops = (ew_flops / F32 + mm_flops / BF16_TC) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rows():
    bf = 2
    # 1-2: the DCE curve kernels (chip_smoke.py phase 7)
    el = 48 * 1088 * 1920 * 3
    yield ("1 fused_curve_upsample_apply", "(48,1088,1920,3)+(48,136,240,3) bf16",
           (2 * el + el // 64) * bf, el * (12 + 3 * 8), 0)
    el = 1088 * 1920 * 3
    yield ("2 fused_curve_apply", "(1,1088,1920,3)+(1,1088,1920,24) bf16",
           (2 * el + 8 * el) * bf, el * 24, 0)
    # 3-4: K1 and K2 of the fused NAFBlock at the NAFNet-TLC serving shapes
    for b, h, w, c in ((2, 736, 1280, 32), (2, 368, 640, 64)):
        px = b * h * w
        yield (f"3 k1_apply C={c}", f"({b},{h},{w},{c}) bf16",
               (2 * px * c + 2 * c * c + 24 * c) * bf, px * 44 * c, px * 4 * c * c)
        yield (f"4 k2_apply C={c}, TLC", f"({b},{h},{w},{c}) x3 in, 1 out, bf16",
               (4 * px * c + 5 * c * c + 9 * c) * bf, px * 13 * c, px * 10 * c * c)
    # 5-6: Restormer R1/R2 at level 1 (dim 48, 1 head, hidden int(2.66*48)),
    # on a chunk of 8 tiles of 384x384 (bench_all.py's 1080p tiled-384 row)
    b, t, c, heads = 8, 384, 48, 1
    hd, hid, px = c // heads, int(2.66 * c), 8 * 384 * 384
    yield ("5 R1 (_r1_kernel)", f"({b},{t},{t},{c}) bf16 -> V, per-head gram",
           (2 * px * c + c * 3 * c + 27 * c + 2 * c) * bf + b * (heads * hd * hd + 2 * c) * 4,
           px * (7 * c + 54 * c + 4 * c), px * (6 * c * c + 2 * c * hd))
    yield ("6 R2 (_r2_kernel)", f"({b},{t},{t},{c}) x, V in, out; hidden {hid}",
           (3 * px * c + c * c + 2 * c * 2 * hid + 18 * hid + hid * c) * bf,
           px * (7 * c + 36 * hid + 30 * hid + 2 * c),
           px * (2 * c * hd + 2 * c * c + 4 * c * hid + 2 * hid * c))
    # 7-8: the probes at their default shapes
    for c in (288, 512):
        el = 15 * 256 * 256 * c
        yield (f"7 dw_kernel probe, c={c}", f"(15,256,256,{c}) bf16", 2 * el * bf, el * 18, 0)
    el = 15 * 256 * 256 * 128
    yield ("8 gelu_kernel probe", "(15,256,256,128) f32", 2 * el * 4, el * 30, 0)


def main() -> None:
    print("| kernel | shape | bytes | bound | by |")
    print("|---|---|---|---|---|")
    for name, shape, nbytes, ew, mm in rows():
        ms, by = bound(nbytes, ew, mm)
        print(f"| {name} | {shape} | {nbytes / 1e9:.4f} GB | {ms:.4f} ms | {by} |")


if __name__ == "__main__":
    main()
