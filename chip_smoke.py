"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python chip_smoke.py``.
It needs one CUDA card, nvcc and the ``enhax_torch`` package beside it; it
imports nothing of JAX or of the ``enhax`` package. Phases:

  1. the card's name and power limit (nvidia-smi), CUDA and torch versions;
  2. build every kernel source under ``enhax_torch/kernels/csrc`` (one nvcc
     per source, all at once);
  3. each kernel against its plain PyTorch version on the card: ragged
     shapes and the main path's shapes (for K1 and K2 also shapes ragged
     against the bf16 forms' strips, runs and tiles, with the form each
     width takes). The DCE curve kernels: float32
     (max|d| <= 1e-5) and bfloat16 (<= 1 uint8 LSB after x255, round,
     clip); the upsample kernel on both its paths, each case naming the
     path ``upsample_path`` picks and failing if the wrapper took another
     ("vec" at s = 2, 4, 8 with N > 1 and H of one band, of several and of
     more than 65,535 rows in all, and at the bench chunk's shape;
     "general" at W not a multiple of 8, C != 3, a scale of 3 and a
     misaligned base). The NAFBlock kernels K1 and K2 and the
     RestormerBlock kernels' outputs (R1's v, R2's block output): max|d|
     <= 1e-5 (float32) or 2^-6 (bfloat16, two bf16 steps) times max(1,
     max|ref|), and in float32 the first and last rows and columns no
     worse than twice the interior.
     R1's gram and sums of squares (float32 sums over all pixels in another
     order; the plain version sums in float64): max|d| <= 1e-5 * max|ref|
     in float32; in bfloat16 <= 1e-3 * max|ref|: the 1x1's operand is LN(x)
     rounded to bf16, and an LN output one float32 step apart may round the
     other way, which moves q and k (and the gram's rounded operands);
  4. each model on the card against the same weights on the CPU, float32
     with TF32 off: zero_dce++_re (scale_factor=8) and zero_dce_re,
     max|d| <= 1e-4; nafnet_local at full width, beta and gamma drawn,
     restormer at full width on 1x128x128 (levels 0-2 fused, the 16x16
     latent the module's block), temperature and LayerNorms drawn, and
     hinet_re at the published width (88,669,702 params) on 1x64x64, both
     outputs, biases and instance norms drawn, max|d| <= 1e-4 * max(1,
     max|ref|); a zero_dce++_re train step (the differentiable curve loop,
     no curve kernel) against the CPU step, loss and every gradient within
     1e-4 x max(1, max|ref|), then one curve kernel launch in the eval step,
     whose loss and output agree with the CPU eval step's as closely (HINet
     and these steps draw from generators of their own and leave torch's
     as it was, as does HINet's serving in phase 5, so every other phase
     runs on the inputs it had before them);
  5. the main paths, serving: a bf16 ``Predictor`` per model answers a few
     requests. Launch counts are reset just before each request and read
     just after it; every zero_dce++_re request launches the upsample
     kernel once on its "vec" path (``path_launches``), zero_dce_re the
     apply kernel once; every NAFNet forward launches K1 and K2 8 times each;
     every Restormer forward of a chunk of 384x384 tiles launches R1 and R2
     44 times each (a tiled 1080x1920 frame: 3 chunks, 132); then hinet_re
     (no kernel) answers one tiled request with hinet_tiny_tiled's spec
     (tiles 32, overlap 8, uniform), the predict CLI writes three PNGs and
     the metric CLI scores them against their targets (psnr, ssim,
     ms_ssim; then --use-gt-mean with --save-csv);
  5b. training (``phase_train``): NAFNet-SIDD (configs/nafnet_sidd.py) at
     bench_train.py's 16x256x256. K1/K2 at the training shapes
     (16,256,256,32) and (16,128,128,64) against their plain versions,
     float32 and bf16; a fused step's loss and every gradient against the
     unfused step's (TF32 off; float32 within 1e-4 x max(1, max|ref|) per
     tensor, bf16-mixed within TOL_TRAIN_BF16), remat off and on, K1/K2
     counted a step (8 fused, 16 with remat, none unfused, 8 an eval
     step); the prepared weights once a bf16-mixed step; the train CLI on
     a SIDD-shaped tree (--steps 6, then --steps 10 with
     ENHAX_FUSED_TRAIN=1, resuming from ``last``); then ms a step, train
     MP/s and peak memory of {float32, bf16-mixed} x {unfused, fused} with
     remat and EMA and torch's default TF32 flags, and one profiled step
     each (``build/profiles/profile_train_*.txt``), on a ``{"train": ...}``
     line; then (``phase_train_hinet_zero_dce``) hinet_re at 16x256x256
     with configs/hinet_gopro.py's Adam and restart schedule, float32 and
     bf16-mixed, and zero_dce_re at 8x256x256 with its config's Adam,
     weight decay and clipping (no curve kernel in a train step, one
     fused_curve_apply in an eval step), timed the same way;
     fused_curve_apply against its plain version in float32 at this path's
     shapes (8x256x256 with 24 curves, 2x512x512 shared), and the train
     CLI on configs/hinet_gopro.py with ENHAX_FUSED_TRAIN=1 and on
     configs/zero_dcepp_re_sice_mix.py (one fused_curve_apply in its
     validation) over generated gopro and sice_mix trees;
  6. the bench shapes: ``bench.py``'s 48x1088x1920 uint8 chunks (sf=8,
     bf16, uint8 out; every chunk on the upsample's "vec" path),
     NAFNet-TLC at 2x736x1280 (``bench_all.py`` 3b) in bf16 and float32,
     and Restormer at ``bench_all.py``'s 1080p row (four 1088x1920 frames,
     384x384 tiles, overlap 32, chunks of 8, bf16) through the tiled
     ``Predictor``, and hinet_re at 2x736x1280 (``bench_all.py:153-154``)
     in bf16 and float32 through the ``Predictor``; throughput and peak
     memory, then one batch or request under torch.profiler (device time
     by operator; for NAFNet and HINet its sum, the batch's device time,
     beside the host clock);
  7. each kernel's time by CUDA events at the main path's shapes, against
     its bound and its plain version's time; the upsample kernel also in 5
     alternating turns beside its first design (the "general" path on the
     same inputs) and ``out.copy_(image)`` of the same bytes, at the bench
     shape in bf16 and at (4, 1088, 1920, 3) in float32; K1 and K2 at
     both NAFNet shapes with the form they take (``nafblock.design``); R1
     and R2 at the chunk shape of every Restormer level, each level's line
     naming the form R1 and R2 take there (``restormer_block.design``) and
     R1's grid (blocks against the blocks resident on the card: it fails
     if they take more than one wave), and R1-mxu and R2-mxu at the same
     shapes with their forms and R1-mxu's grid. The dw 3x3 and the GELU are
     set beside the one PyTorch call that computes the same function
     (``library_ms``) and a copy of their input in the probe phase, in 5
     alternating turns; phase 7 reports their median and range (both C and
     both row modes of the dw 3x3 with the path each took, both erf forms).

The tap-folded RestormerBlock kernels (``r1_mxu_apply``, ``r2_mxu_apply``:
the JAX package's ``dw_mxu=True``) and the probe kernels (``dw3x3_apply``,
``gelu_apply``) run in phase 3 against their plain versions (R1-mxu/R2-mxu
at every (C, heads) pair and level, in float32 and bfloat16, and in
bfloat16 also at shapes ragged against their bf16 forms' tiles, with the
RestormerBlock kernels' tolerances; the dw 3x3 in both row modes with the
NAFBlock kernels' bound; the GELU in both erf forms, max|d| <= 1e-6), in
phase 4 (the full-width restormer at 1x128x128, float32, with every fused
block through ``restormer_block_fast(..., dw_mxu=True)``, against the
default fused path on the card, max|d| <= 1e-4 * max(1, max|ref|)), and in
the probe phase: one 1080x1920 bf16 frame through ``tiled_apply_batched``
(tiles 384, overlap 32, chunks of 8) with dw_mxu blocks (R1-mxu = R2-mxu =
132 launches, default R1 = R2 = 0) beside the default path on the same
frame, then the three probes (``enhax_torch.probes``) at their JAX shapes
and the dw_mxu A/B at every chunk level.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failed check raises, so the exit code is not 0 and no result
line is printed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from enhax_torch.infer import Predictor  # noqa: E402
from enhax_torch.infer.tiling import tiled_apply_batched  # noqa: E402
from enhax_torch.kernels import _build, dce_curve, dw3x3, gelu, nafblock  # noqa: E402
from enhax_torch.kernels import restormer_block as rb  # noqa: E402
from enhax_torch.models.base import build_model  # noqa: E402
from enhax_torch.probes import cuda_ms, spread, turns  # noqa: E402
from enhax_torch.probes import dw_mxu as probe_dw_mxu  # noqa: E402
from enhax_torch.probes import dw_roofline as probe_dw_roofline  # noqa: E402
from enhax_torch.probes import gelu_kernel as probe_gelu  # noqa: E402

# H100 SXM, NVIDIA's data sheet: HBM rate, the float32 rate outside the
# tensor cores and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TOL_F32 = 1e-5
TOL_MODEL_F32 = 1e-4
TOL_BF16_LSB = 1
TOL_BF16_REL = 2.0 ** -6
NAFNET_FUSED_BLOCKS = 8   # enc0, enc1, dec2, dec3 at C <= 64, two blocks each
RESTORMER_BLOCKS = 44     # 16 encoder, 8 latent, 16 decoder, 4 refinement
TOL_SUMS_BF16 = 1e-3
TOL_GELU = 1e-6
TILE = (384, 384, 32)     # bench_all.py's restormer_1080p_tiled384_bf16_mf
HINET_PARAMS = 88_669_702  # hinet_re at the published width (64, depth 5)
HINET_TILE = (32, 32, 8)   # run/make_quality.py's hinet_tiny_tiled: tile 32, overlap 8, uniform
# hinet_re's bf16 serving against its float32 serving, x max(1, max|ref|):
# every op's output rounds to bf16; 1e-2 on the CPU (tests/test_torch_hinet.py)
TOL_HINET_BF16 = 3e-2
PROFILES = Path(__file__).resolve().parent / "build" / "profiles"

KERNELS = {
    "fused_curve_upsample_apply": {
        "wrapper": dce_curve.fused_curve_upsample_apply,
        "plain": dce_curve.fused_curve_upsample_apply_plain,
        "source": "enhax_torch/kernels/csrc/dce_curve.cu",
        "replaces": "enhax/kernels/dce_curve.py:81",
    },
    "fused_curve_apply": {
        "wrapper": dce_curve.fused_curve_apply,
        "plain": dce_curve.fused_curve_apply_plain,
        "source": "enhax_torch/kernels/csrc/dce_curve.cu",
        "replaces": "enhax/kernels/dce_curve.py:28",
    },
    "k1_apply": {
        "wrapper": nafblock.k1_apply,
        "plain": nafblock.k1_plain,
        "source": "enhax_torch/kernels/csrc/nafblock.cu",
        "replaces": "enhax/kernels/nafblock.py:167",
    },
    "k2_apply": {
        "wrapper": nafblock.k2_apply,
        "plain": nafblock.k2_plain,
        "source": "enhax_torch/kernels/csrc/nafblock.cu",
        "replaces": "enhax/kernels/nafblock.py:224",
    },
    "r1_apply": {
        "wrapper": rb.r1_apply,
        "plain": rb.r1_plain,
        "source": "enhax_torch/kernels/csrc/restormer_block.cu",
        "replaces": "enhax/kernels/restormer_block.py:327",
    },
    "r2_apply": {
        "wrapper": rb.r2_apply,
        "plain": rb.r2_plain,
        "source": "enhax_torch/kernels/csrc/restormer_block.cu",
        "replaces": "enhax/kernels/restormer_block.py:378",
    },
    "r1_mxu_apply": {
        "wrapper": rb.r1_mxu_apply,
        "plain": rb.r1_mxu_plain,
        "source": "enhax_torch/kernels/csrc/restormer_block.cu",
        "replaces": "enhax/kernels/restormer_block.py:327",
    },
    "r2_mxu_apply": {
        "wrapper": rb.r2_mxu_apply,
        "plain": rb.r2_mxu_plain,
        "source": "enhax_torch/kernels/csrc/restormer_block.cu",
        "replaces": "enhax/kernels/restormer_block.py:378",
    },
    "dw3x3_apply": {
        "wrapper": dw3x3.dw3x3_apply,
        "plain": dw3x3.dw3x3_plain,
        "source": "enhax_torch/kernels/csrc/dw3x3.cu",
        "replaces": "run/probe_dw_roofline.py:98",
    },
    "gelu_apply": {
        "wrapper": gelu.gelu_apply,
        "plain": gelu.gelu_plain,
        "source": "enhax_torch/kernels/csrc/gelu.cu",
        "replaces": "run/probe_gelu_kernel.py:83",
    },
}
DCE = ("fused_curve_upsample_apply", "fused_curve_apply")
NAF = ("k1_apply", "k2_apply")
RST = ("r1_apply", "r2_apply")
MXU = ("r1_mxu_apply", "r2_mxu_apply")


def fail(msg: str):
    raise RuntimeError(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        if hasattr(k["wrapper"], "path_launches"):
            k["wrapper"].path_launches = dict.fromkeys(k["wrapper"].path_launches, 0)


def up_paths() -> dict:
    return dict(dce_curve.fused_curve_upsample_apply.path_launches)


def counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x.float() * 255.0).round().clamp(0, 255).to(torch.uint8)


def rand(gen: np.random.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    a = gen.uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def compare(name: str, args: tuple, kwargs: dict) -> float:
    """Run the kernel and its plain version on the same card inputs; return
    max|d| in float32 and check it against the dtype's tolerance."""
    k = KERNELS[name]
    before = up_paths()
    with torch.inference_mode():
        out = k["wrapper"](*args, **kwargs)
        ref = k["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    if name == "fused_curve_upsample_apply":
        path = dce_curve.upsample_path(args[0].shape, args[0].dtype, kwargs["scale"],
                                       args[0].data_ptr())
        took = [p for p, v in up_paths().items() if v != before[p]]
        if took != [path]:
            fail(f"{name} at {tuple(args[0].shape)}: upsample_path says {path}, took {took}")
        kwargs = {**kwargs, "path": path}
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"{name}: bad output {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    shape = tuple(args[0].shape)
    if name in NAF:
        ok = check_rel(name, out, ref)
    elif name == "dw3x3_apply":
        path = dw3x3.dw3x3_path(args[0].shape, args[0].dtype, args[0].data_ptr())
        ok = check_rel(f"{name} {kwargs} path={path}", out, ref)
    elif name == "gelu_apply":
        ok = err <= TOL_GELU
        print(f"  {name} {shape} {kwargs}: max|d|={err:.3e} (tol {TOL_GELU})")
    elif args[0].dtype == torch.float32:
        ok = err <= TOL_F32
        print(f"  {name} {shape} float32 {kwargs}: max|d|={err:.3e} (tol {TOL_F32})")
    else:
        lsb = (to_u8(out).int() - to_u8(ref).int()).abs().max().item()
        ok = lsb <= TOL_BF16_LSB
        print(f"  {name} {shape} bfloat16 {kwargs}: max|d|={err:.3e}, "
              f"{lsb} uint8 LSB (tol {TOL_BF16_LSB})")
    if not ok:
        fail(f"{name} disagrees with its plain version at {shape}")
    return err


def check_rel(name: str, out: torch.Tensor, ref: torch.Tensor) -> bool:
    """The NAFBlock kernels' bound: 1e-5 (float32) or 2^-6 (bfloat16) times
    max(1, max|ref|); in float32 also each first and last row and column
    against twice the interior's error."""
    d = (out.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    tol = (TOL_F32 if out.dtype == torch.float32 else TOL_BF16_REL) * scale
    err = d.max().item()
    edges = ""
    ok = err <= tol
    if out.dtype == torch.float32 and out.shape[1] > 2 and out.shape[2] > 2:
        inner = max(d[:, 1:-1, 1:-1].max().item(), tol / 8)
        worst = max(e.max().item() for e in (d[:, 0], d[:, -1], d[:, :, 0], d[:, :, -1]))
        edges = f", edges {worst:.3e} vs interior {inner:.3e}"
        ok = ok and worst <= 2 * inner
    print(f"  {name} {tuple(out.shape)} {str(out.dtype)[6:]}: max|d|={err:.3e} "
          f"(tol {tol:.3e}){edges}")
    return ok


def block_params(c: int, dtype, gen) -> dict:
    """A NAFBlock's params on the card: every one shifted and beta/gamma
    drawn from ``gen`` (at their zero init the block returns x, and nothing
    after the gate would be checked)."""
    from enhax_torch.models.multitask.nafnet import NAFBlock
    blk = NAFBlock(c)
    perturb(blk, gen, 0.1, 0.5)
    return dict(blk.to("cuda", dtype).named_parameters())


@torch.no_grad()
def perturb(module: torch.nn.Module, gen, shift: float, residual: float) -> None:
    """Add U(0, shift) to every param, U(-residual, residual) to beta and gamma."""
    for name, prm in module.named_parameters():
        lo, hi = ((-residual, residual) if name.endswith(("beta", "gamma"))
                  else (0.0, shift))
        prm.add_(torch.from_numpy(gen.uniform(lo, hi, prm.shape).astype(np.float32)))


# (N, H, W, C), scale of the upsample's checks: W % 8 != 0 ("general"),
# then the "vec" path, then C != 3 and a scale of 3 ("general")
UPSAMPLE_CASES = [((2, 36, 52, 3), 4), ((2, 40, 72, 3), 8), ((1, 8, 8, 3), 8),
                  ((2, 16, 64, 3), 2), ((3, 36, 48, 3), 4), ((2, 64, 128, 3), 4),
                  ((3, 22000, 8, 3), 8), ((2, 40, 72, 4), 8), ((1, 18, 24, 3), 3)]

# each level's chunk shape on the tiled path (8 tiles of 384x384) and heads
RESTORMER_LEVELS = [((8, 384, 384, 48), 1), ((8, 384, 384, 96), 1), ((8, 192, 192, 96), 2),
                    ((8, 96, 96, 192), 4), ((8, 48, 48, 384), 8)]
# (B, H, W) ragged against both tiles of the RestormerBlock kernels (8x8 and
# 8x16): H and W not multiples of 8 or 16, several tiles an image, one row
RESTORMER_RAGGED = ((2, 19, 29), (1, 1, 37), (1, 37, 53))
# and against the tap-folded bf16 forms' tiles (8x16, 8x8 at C = 384): H not
# a multiple of 8, W not a multiple of 16 (nor of 8), W < 16, one row
MXU_RAGGED = ((1, 13, 21), (2, 9, 7), (1, 1, 5), (2, 17, 40))


@torch.no_grad()
def draw_restormer(module: torch.nn.Module, gen) -> None:
    """Temperature drawn in [0.5, 3] and the LayerNorms shifted by
    U(-0.2, 0.2): at their init the softmax is nearly flat and would hide a
    wrong normalisation."""
    for name, prm in module.named_parameters():
        if name.endswith("temperature"):
            prm.copy_(torch.from_numpy(gen.uniform(0.5, 3.0, prm.shape).astype(np.float32)))
        elif ".body." in name:
            prm.add_(torch.from_numpy(gen.uniform(-0.2, 0.2, prm.shape).astype(np.float32)))


def restormer_params(c: int, heads: int, dtype, gen) -> dict:
    """A RestormerBlock's params on the card, temperature and LayerNorms drawn."""
    from enhax_torch.models.multitask.restormer import RestormerBlock
    blk = RestormerBlock(c, heads)
    draw_restormer(blk, gen)
    return dict(blk.to("cuda", dtype).named_parameters())


def compare_restormer(shape: tuple, heads: int, dtype, gen,
                      mxu: bool = False) -> tuple[float, float]:
    """R1 and R2 (``mxu``: R1-mxu and R2-mxu) against their plain versions
    on the same card inputs (R2 takes the plain R1's v and the glue's
    attention, as on the path); returns max|d| of R1's v and of R2's output."""
    r1, r2 = MXU if mxu else RST
    p = restormer_params(shape[-1], heads, dtype, gen)
    x = rand(gen, shape, -1, 1, dtype)
    with torch.inference_mode():
        out = KERNELS[r1]["wrapper"](x, p)
        ref = KERNELS[r1]["plain"](x, p)
        attn = rb.mdta_attention(*ref[1:], p["attn.temperature"], dtype)
        out2 = KERNELS[r2]["wrapper"](x, ref[0], attn, p)
        ref2 = KERNELS[r2]["plain"](x, ref[0], attn, p)
    torch.cuda.synchronize()
    for o, r in zip((*out, out2), (*ref, ref2)):
        if o.shape != r.shape or o.dtype != r.dtype or not torch.isfinite(o.float()).all():
            fail(f"restormer kernels: bad output {tuple(o.shape)} vs {tuple(r.shape)}")
    ok = check_rel(f"{r1} v heads={heads}", out[0], ref[0])
    for name, o, r in zip(("gram", "qss", "kss"), out[1:], ref[1:]):
        rel = TOL_SUMS_BF16 if dtype == torch.bfloat16 else TOL_F32
        err, scale = (o - r).abs().max().item(), r.abs().max().item()
        print(f"    {name}: max|d|={err:.3e} (tol {rel * scale:.3e})")
        ok = ok and err <= rel * scale
    ok = check_rel(f"{r2} heads={heads}", out2, ref2) and ok
    if not ok:
        fail(f"{r1}/{r2} disagree with their plain versions at {shape}, {dtype}")
    return ((out[0].float() - ref[0].float()).abs().max().item(),
            (out2.float() - ref2.float()).abs().max().item())


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> None:
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    seconds = _build.build(names)
    print(f"[build] {names} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{n}: {s:.1f} s' for n, s in seconds.items())})")
    for n in names:
        log = _build.library_path(n).with_name(_build.library_path(n).name + ".log")
        entry = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                # the mangled kernel name, its namespace prefix dropped
                entry = line.split("'")[1].split("_cu_")[-1][8:]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {n} {entry}: {line.strip().removeprefix('ptxas info    : ')}")


def phase_kernels(gen) -> dict:
    """Kernel vs plain version; returns max|d| at the main path's shapes."""
    print("[kernels] kernel vs plain version on the card")
    up, ap = "fused_curve_upsample_apply", "fused_curve_apply"
    # the upsample's cases past the first two draw from a generator of their
    # own, so the other kernels' inputs do not depend on how many there are
    ugen = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        # the upsample's "general" and "vec" paths, then the "vec" path at
        # s = 2, 4, 8 (H of one band of 16 rows, of several with a short
        # last one, N x H past 65,535 rows) and the "general" path (C != 3,
        # a scale of 3, a base 2 elements off 16-byte alignment)
        for i, (shape, s) in enumerate(UPSAMPLE_CASES):
            n, h, w, c = shape
            g = gen if i < 2 else ugen
            x = rand(g, shape, 0, 1, dtype)
            r = rand(g, (n, h // s, w // s, c), -1, 1, dtype)
            compare(up, (x, r), {"num_iters": 8, "scale": s})
        shape = (2, 32, 64, 3)
        x = torch.empty(int(np.prod(shape)) + 2, device="cuda", dtype=dtype)[2:].view(shape)
        x.copy_(rand(ugen, shape, 0, 1, dtype))
        compare(up, (x, rand(ugen, (2, 4, 8, 3), -1, 1, dtype)), {"num_iters": 8, "scale": 8})
        x = rand(gen, (2, 37, 53, 3), 0, 1, dtype)
        for shared, rc in ((False, 24), (True, 3)):
            r = rand(gen, (2, 37, 53, rc), -1, 1, dtype)
            compare(ap, (x, r), {"num_iters": 8, "shared": shared})
    # the main path's shapes: zero_dce++ at sf=8 on 48 frames of 1088x1920,
    # zero_dce_re on one 1080p frame (padded to 1088x1920), both bfloat16
    errs = {}
    x = rand(gen, (48, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    r = rand(gen, (48, 136, 240, 3), -1, 1, torch.bfloat16)
    if dce_curve.upsample_path(x.shape, x.dtype, 8, x.data_ptr()) != "vec":
        fail("the bench chunk's shape does not take the upsample's vec path")
    errs[up] = compare(up, (x, r), {"num_iters": 8, "scale": 8})
    x = rand(gen, (1, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    r = rand(gen, (1, 1088, 1920, 24), -1, 1, torch.bfloat16)
    errs[ap] = compare(ap, (x, r), {"num_iters": 8, "shared": False})
    # the NAFBlock kernels: ragged shapes (H, W not multiples of the general
    # K1's 14x30 tile; for the bf16 forms W not a multiple of K1's strip, 62
    # columns at C <= 32 and 30 at C = 64, H of one, two and 67 rows (two of
    # K1's runs of 64), pixel counts not a multiple of K2's 16-pixel tiles,
    # B = 3), then the main path's, where K2 takes the TLC local mean of K1's
    # output; both pooled forms
    for dtype in (torch.float32, torch.bfloat16):
        print(f"  forms {str(dtype)[6:]}: "
              f"{ {c: nafblock.design(c, dtype) for c in nafblock.KERNEL_CHANNELS} }")
        for shape in ((2, 17, 37, 8), (1, 1, 45, 16), (3, 29, 61, 32), (1, 15, 31, 64),
                      (2, 1, 7, 64), (3, 1, 65, 8), (3, 2, 129, 16), (3, 67, 125, 32),
                      (3, 2, 63, 32), (3, 1, 31, 64), (3, 67, 61, 64)):
            b, _, _, c = shape
            p = block_params(c, dtype, gen)
            x = rand(gen, shape, -1, 1, dtype)
            compare("k1_apply", (x, p), {})
            g = rand(gen, shape, -1, 1, dtype)
            for pooled_shape in (shape, (b, 1, 1, c)):
                compare("k2_apply", (x, g, rand(gen, pooled_shape, -1, 1, dtype), p), {})
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 736, 1280, 32), (2, 368, 640, 64)):
            b, _, _, c = shape
            p = block_params(c, dtype, gen)
            x = rand(gen, shape, -1, 1, dtype)
            e1 = compare("k1_apply", (x, p), {})
            with torch.inference_mode():
                g = nafblock.k1_plain(x, p)
                tlc = nafblock.box_mean_fast(g, 128)
            e2 = compare("k2_apply", (x, g, tlc, p), {})
            compare("k2_apply", (x, g, g.mean(dim=(1, 2), keepdim=True), p), {})
            if dtype == torch.bfloat16 and c == 32:
                errs["k1_apply"], errs["k2_apply"] = e1, e2
    # the RestormerBlock kernels: ragged shapes (H and W not multiples of
    # the tile, several tiles an image, one-row images) at each (C, heads)
    # pair, then each level's chunk shape of the tiled path
    for dtype in (torch.float32, torch.bfloat16):
        for c, heads in rb.KERNEL_WIDTHS:
            for hw in RESTORMER_RAGGED:
                compare_restormer(hw + (c,), heads, dtype, gen)
        for shape, heads in RESTORMER_LEVELS:
            e = compare_restormer(shape, heads, dtype, gen)
            if dtype == torch.bfloat16 and shape == RESTORMER_LEVELS[0][0]:
                errs["r1_apply"], errs["r2_apply"] = e
    # their tap-folded forms, the same cases
    for dtype in (torch.float32, torch.bfloat16):
        for c, heads in rb.KERNEL_WIDTHS:
            for hw in RESTORMER_RAGGED:
                compare_restormer(hw + (c,), heads, dtype, gen, mxu=True)
        for shape, heads in RESTORMER_LEVELS:
            e = compare_restormer(shape, heads, dtype, gen, mxu=True)
            if dtype == torch.bfloat16 and shape == RESTORMER_LEVELS[0][0]:
                errs["r1_mxu_apply"], errs["r2_mxu_apply"] = e
    # and in bf16 at shapes ragged against their bf16 forms' tiles; these
    # draw from generators of their own (numpy's, and torch's for the
    # blocks), so every other check's inputs are as they were
    forms = {f"{c}/{heads}": rb.design(1, c, heads, mxu=True) for c, heads in rb.KERNEL_WIDTHS}
    print(f"  mxu forms bfloat16 (C/heads): {forms}")
    mgen = np.random.default_rng(2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        for c, heads in rb.KERNEL_WIDTHS:
            for hw in MXU_RAGGED:
                compare_restormer(hw + (c,), heads, torch.bfloat16, mgen, mxu=True)
    # the probe kernels: ragged shapes (the column walk where C is not a
    # multiple of the 4-channel vector or x is 2 elements off 16-byte
    # alignment; the TMA ring with C not a multiple of its channel chunk, W
    # not a multiple of its column tile, one- and two-row images), then the
    # probes' shapes, bf16 as the dw probe runs (and float32); the GELU over
    # [-6, 6], n = 4k + 3 and not a multiple of a block's pass
    for shape in ((2, 19, 29, 37), (1, 1, 37, 8), (3, 7, 33, 40), (1, 2, 257, 520),
                  (2, 1, 65, 288), (15, 256, 256, 288), (15, 256, 256, 512)):
        for dtype in ((torch.bfloat16, torch.float32) if shape[0] < 15 else (torch.bfloat16,)):
            x = rand(gen, shape, -1, 1, dtype)
            k = rand(gen, (3, 3, shape[-1]), -1, 1, dtype)
            for rows in dw3x3.ROWS:
                e = compare("dw3x3_apply", (x, k), {"rows": rows})
                if shape == (15, 256, 256, 288) and rows == "zero":
                    errs["dw3x3_apply"] = e
            if shape[0] < 15:
                xs = torch.empty(x.numel() + 2, device="cuda", dtype=dtype)[2:].view(shape)
                xs.copy_(x)
                compare("dw3x3_apply", (xs, k), {"rows": "zero"})
    for shape in ((1001,), (4 * 4099 + 3,), probe_gelu.SHAPE):
        x = rand(gen, shape, -6, 6, torch.float32)
        for erf in gelu.ERFS:
            e = compare("gelu_apply", (x,), {"erf": erf})
            if len(shape) > 1 and erf == "as":
                errs["gelu_apply"] = e
    return errs


def phase_model_vs_cpu(gen) -> None:
    print("[model] card vs CPU, float32, TF32 off")
    reset_counts()
    for name, kw in (("zero_dce++_re", {"scale_factor": 8.0}), ("zero_dce_re", {})):
        gpu = build_model(name, device="cuda", seed=0, **kw)
        cpu = build_model(name, device="cpu", seed=0, **kw)
        for h, w in ((1088, 1920), (256, 256)):
            x = gen.uniform(0, 0.3, (1, h, w, 3)).astype(np.float32)
            with torch.inference_mode():
                og = gpu.apply({"image": torch.from_numpy(x).cuda()})
                oc = cpu.apply({"image": torch.from_numpy(x)})
            for key in ("enhanced", "adjust"):
                err = (og[key].cpu() - oc[key]).abs().max().item()
                print(f"  {name} {kw} {h}x{w} {key}: max|d|={err:.3e} "
                      f"(tol {TOL_MODEL_F32})")
                if not err <= TOL_MODEL_F32:
                    fail(f"{name} on the card disagrees with the CPU run ({key})")
    c = counts()
    print(f"  launches: {c}")
    if min(c[k] for k in DCE) < 1:
        fail(f"a kernel was not launched by the models: {c}")

    # NAFNet-TLC at the published width; beta and gamma drawn, so every
    # block does work. The TLC window (256) stays local in W at 368x640.
    cpu = build_model("nafnet_local", device="cpu", seed=0)
    perturb(cpu.module, gen, 0.002, 0.2)
    gpu = build_model("nafnet_local", device="cpu", seed=0)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    x = gen.uniform(0, 1, (1, 368, 640, 3)).astype(np.float32)
    reset_counts()
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})["enhanced"].cpu()
        oc = cpu.apply({"image": torch.from_numpy(x)})["enhanced"]
    c = counts()
    err = (og - oc).abs().max().item()
    tol = TOL_MODEL_F32 * max(1.0, oc.abs().max().item())
    print(f"  nafnet_local 368x640 enhanced: max|d|={err:.3e} (tol {tol:.3e}), "
          f"max|ref|={oc.abs().max().item():.3f}; launches: {c}")
    if not (err <= tol and torch.isfinite(og).all()):
        fail("nafnet_local on the card disagrees with the CPU run")
    if any(c[k] != NAFNET_FUSED_BLOCKS for k in NAF):
        fail(f"a NAFNet forward launched K1/K2 other than {NAFNET_FUSED_BLOCKS} times: {c}")

    # Restormer at the published width on 1x128x128: levels 0-2 (128, 64,
    # 32) fused, the 16x16 latent (8 blocks) the module's block
    cpu = build_model("restormer", device="cpu", seed=0)
    draw_restormer(cpu.module, gen)
    gpu = build_model("restormer", device="cpu", seed=0)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    x = gen.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    reset_counts()
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})["enhanced"].cpu()
        oc = cpu.apply({"image": torch.from_numpy(x)})["enhanced"]
    c = counts()
    err = (og - oc).abs().max().item()
    tol = TOL_MODEL_F32 * max(1.0, oc.abs().max().item())
    print(f"  restormer 128x128 enhanced: max|d|={err:.3e} (tol {tol:.3e}), "
          f"max|ref|={oc.abs().max().item():.3f}; launches: {c}")
    if not (err <= tol and torch.isfinite(og).all()):
        fail("restormer on the card disagrees with the CPU run")
    if any(c[k] != RESTORMER_BLOCKS - 8 for k in RST):
        fail(f"a Restormer forward at 128x128 launched R1/R2 other than "
             f"{RESTORMER_BLOCKS - 8} times: {c}")

    # the same network and input with every fused block in its tap-folded
    # form, against the default fused path on the card
    reset_counts()
    with torch.inference_mode():
        om = mxu_forward(gpu.module, torch.from_numpy(x).cuda())["enhanced"].cpu()
    c = counts()
    err = (om - og).abs().max().item()
    tol = TOL_MODEL_F32 * max(1.0, og.abs().max().item())
    print(f"  restormer 128x128, dw_mxu blocks vs default fused on the card: max|d|={err:.3e} "
          f"(tol {tol:.3e}); launches: {c}")
    if not (err <= tol and torch.isfinite(om).all()):
        fail("restormer with dw_mxu blocks disagrees with the default fused path")
    if any(c[k] != RESTORMER_BLOCKS - 8 for k in MXU) or any(c[k] for k in RST):
        fail(f"the dw_mxu forward at 128x128 launched R1-mxu/R2-mxu other than "
             f"{RESTORMER_BLOCKS - 8} times, or the default R1/R2: {c}")

    # HINet and the Zero-DCE step draw from a generator of their own and
    # leave torch's untouched (its layers' default init draws from it), so
    # the later phases' inputs do not depend on them
    with torch.random.fork_rng():
        hinet_vs_cpu(np.random.default_rng(12))
        zero_dce_step_vs_cpu(np.random.default_rng(15))


def hinet_vs_cpu(gen) -> None:
    """hinet_re at the published width (no kernel of its own, cuDNN's
    convs) on the card against the CPU, both outputs."""
    cpu = build_model("hinet_re", device="cpu", seed=0)
    draw_hinet(cpu.module, gen)
    gpu = build_model("hinet_re", device="cpu", seed=0)
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    if gpu.param_count() != HINET_PARAMS:
        fail(f"hinet_re has {gpu.param_count()} params, expected {HINET_PARAMS}")
    x = gen.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        og = gpu.apply({"image": torch.from_numpy(x).cuda()})
        oc = cpu.apply({"image": torch.from_numpy(x)})
    for key in ("stage1", "enhanced"):
        err = (og[key].cpu() - oc[key]).abs().max().item()
        tol = TOL_MODEL_F32 * max(1.0, oc[key].abs().max().item())
        print(f"  hinet_re 64x64 {key}: max|d|={err:.3e} (tol {tol:.3e}), "
              f"max|ref|={oc[key].abs().max().item():.3f}")
        if not (err <= tol and torch.isfinite(og[key]).all()):
            fail(f"hinet_re on the card disagrees with the CPU run ({key})")


@torch.no_grad()
def draw_hinet(module: torch.nn.Module, gen) -> None:
    """Biases and the instance norms' weights shifted by U(-0.1, 0.1): at
    their init (zeros, ones) a wrong bias or affine would not show."""
    for name, prm in module.named_parameters():
        if name.endswith("bias") or ".norm." in name:
            prm.add_(torch.from_numpy(gen.uniform(-0.1, 0.1, prm.shape).astype(np.float32)))


def zero_dce_step_vs_cpu(gen) -> None:
    """Fault 3.7: a zero_dce++_re train step (lr 0, the gradient norm
    clipped to 0.1 as its config clips) on the card runs the differentiable
    curve loop once (``ZeroDCE.curve_loop_forwards``), no curve kernel, and
    gives the CPU step's loss and every gradient within 1e-4 x max(1,
    max|ref|) (float32, TF32 off); the eval step after it launches
    fused_curve_apply once, and its loss and ``enhanced`` agree with the CPU
    eval step's within the same bound."""
    from enhax_torch.models.llie.zero_dce import ZeroDCE
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import TrainState, make_eval_step, make_train_step
    x = torch.from_numpy(gen.uniform(0, 0.3, (2, 128, 192, 3)).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model("zero_dce++_re", device=dev, seed=0)
        tx = build_optimizer({"optimizer": {"name": "adam", "lr": 0.0}})
        step = make_train_step(model, tx, gradient_clip_val=0.1)
        batch = {"image": x.to(dev)}
        reset_counts()
        loops = ZeroDCE.curve_loop_forwards
        loss = step(TrainState(0, model.module, tx.init(model.module.parameters())),
                    batch)["loss"].item()
        train_counts = {**{k: counts()[k] for k in DCE},
                        "curve_loop": ZeroDCE.curve_loop_forwards - loops}
        grads = {k: p.grad.cpu() for k, p in model.module.named_parameters()}
        reset_counts()
        eval_loss = make_eval_step(model)(model.module, batch)["loss"].item()
        eval_counts = {k: counts()[k] for k in DCE}
        with torch.inference_mode():
            enhanced = model.apply(batch)["enhanced"].cpu()
        res[dev] = (loss, grads, train_counts, eval_loss, eval_counts, enhanced)
    (loss_ref, ref, _, eval_ref, _, enh_ref) = res["cpu"]
    (loss, grads, c, eval_loss, ce, enh) = res["cuda"]
    gap = max((grads[k] - g).abs().max().item() / max(1.0, g.abs().max().item())
              for k, g in ref.items())
    loss_gap = abs(loss - loss_ref) / max(1.0, abs(loss_ref))
    eval_gap = max(abs(eval_loss - eval_ref) / max(1.0, abs(eval_ref)),
                   (enh - enh_ref).abs().max().item() / max(1.0, enh_ref.abs().max().item()))
    print(f"  zero_dce++_re train step on the card vs the CPU: loss {loss:.6f} / "
          f"{loss_ref:.6f} (gap {loss_gap:.3e}), gradients max|d|/max(1, max|ref|) "
          f"{gap:.3e} (tol {TOL_MODEL_F32}); launches in the step {c}; the eval step "
          f"after it: loss {eval_loss:.6f} / {eval_ref:.6f}, loss and enhanced max|d|/max(1, "
          f"max|ref|) {eval_gap:.3e}, launches {ce}")
    if not (loss_gap <= TOL_MODEL_F32 and gap <= TOL_MODEL_F32):
        fail("the zero_dce++_re train step on the card disagrees with the CPU step")
    if not (eval_gap <= TOL_MODEL_F32 and torch.isfinite(enh).all()):
        fail("the zero_dce++_re eval step on the card disagrees with the CPU eval step")
    if c != {DCE[0]: 0, DCE[1]: 0, "curve_loop": 1} or ce != {DCE[0]: 0, DCE[1]: 1}:
        fail(f"curve kernels launched {c} in a train step, {ce} in an eval step; "
             "expected the curve loop once, then one fused_curve_apply")


def mxu_forward(net, x: torch.Tensor) -> dict:
    """``restormer_fast_apply`` with every fused block in its tap-folded form
    (``restormer_block_fast(..., dw_mxu=True)``), through the module's
    ``forward(x, block=...)`` hook, as the JAX flag runs it: fused where
    min(H, W) >= 32, the module's block below."""

    def block(y, blk):
        if min(y.shape[1], y.shape[2]) >= 32:
            return rb.restormer_block_fast(y.contiguous(), dict(blk.named_parameters()),
                                           dw_mxu=True)
        return blk(y)

    return net(x, block=block)


def check_out(out: dict, shape: tuple, unit: bool = True) -> None:
    y = out["enhanced"]
    if tuple(y.shape) != shape:
        fail(f"output {tuple(y.shape)}, expected {shape}")
    if not torch.isfinite(y).all():
        fail("output not finite")
    if unit and (y.min() < 0 or y.max() > 1):
        fail("output outside [0, 1]")


def profiled(fn, name: str) -> tuple:
    """Run ``fn`` once under torch.profiler and synchronise; the whole
    table (by self device time) goes to build/profiles/profile_<name>.txt.
    Returns the key averages, the table and the device time in ms: the
    device events' own time (an op's entry repeats its kernels' time, so
    the sum over all entries would count it twice)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=60,
                           max_name_column_width=70)
    PROFILES.mkdir(parents=True, exist_ok=True)
    (PROFILES / f"profile_{name}.txt").write_text(table)
    device_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3
    return averages, table, device_ms


@contextlib.contextmanager
def default_tf32():
    """torch's default TF32 flags, as a user trains: cuDNN's convs in TF32,
    matmuls in float32 (the checks run with TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def phase_serve(gen) -> dict:
    """The main path: Predictors answering requests. Counts are reset before
    each request and read after it; every zero_dce++_re request (padded to
    a multiple of 32) launches the upsample kernel once, on its "vec" path.
    Returns the launches of all requests."""
    print("[serve] bf16 Predictors answering requests")
    pp = Predictor(build_model("zero_dce++_re", scale_factor=8.0), bf16=True)
    pr = Predictor(build_model("zero_dce_re"), bf16=True)
    frame = gen.uniform(0, 0.3, (1080, 1920, 3)).astype(np.float32)
    frames = [gen.uniform(0, 0.3, (720, 1280, 3)).astype(np.float32) for _ in range(4)]
    odd = gen.uniform(0, 0.3, (601, 803, 3)).astype(np.float32)
    pp.infer({"image": frame})  # first request: cuDNN picks its algorithms
    torch.cuda.synchronize()
    total = dict.fromkeys(DCE, 0)

    def served(label, out, shape, upsample):
        torch.cuda.synchronize()
        c, paths = counts(), up_paths()
        check_out(out, shape)
        print(f"  {label}: {out['time'] * 1e3:.3f} ms (host clock, synchronised), "
              f"launches {c}, upsample paths {paths}")
        want = {"general": 0, "vec": 1} if upsample else {"general": 0, "vec": 0}
        if paths != want or c[DCE[0]] != int(upsample) or c[DCE[1]] != int(not upsample):
            fail(f"{label}: launched {c}, upsample paths {paths}")
        for k in DCE:
            total[k] += c[k]

    reset_counts()
    served("zero_dce++_re 1080x1920", pp.infer({"image": frame}), (1, 1080, 1920, 3), True)
    reset_counts()
    batches = list(pp.predict_iter(({"image": f} for f in frames), batch_size=4))
    if len(batches) != 1:
        fail(f"predict_iter made {len(batches)} batches of 4 same-shaped frames")
    served("zero_dce++_re 4x720x1280", batches[0][0], (4, 720, 1280, 3), True)
    reset_counts()
    served("zero_dce++_re 601x803", pp.infer({"image": odd}), (1, 601, 803, 3), True)
    reset_counts()
    served("zero_dce_re 1080x1920", pr.infer({"image": frame}), (1, 1080, 1920, 3), False)
    print(f"  launches: {total}")
    if min(total.values()) < 1:
        fail(f"a kernel of the path was not launched while serving: {total}")
    return total


def phase_serve_nafnet(gen) -> dict:
    """The NAFNet-TLC path: a bf16 Predictor answers a 2x736x1280 batch
    (predict_iter), a 720x1280 frame and a 601x803 frame (padded to
    608x816). Counts are reset before each request and read after it.
    Returns the launches of all three."""
    print("[serve] bf16 Predictor, nafnet_local at full width")
    pred = Predictor(build_model("nafnet_local"), bf16=True)
    frames = [gen.uniform(0, 1, (736, 1280, 3)).astype(np.float32) for _ in range(2)]
    pred.infer({"image": frames[0]})  # first request: cuDNN picks its algorithms
    torch.cuda.synchronize()
    total = dict.fromkeys(NAF, 0)

    def served(label, out, shape):
        torch.cuda.synchronize()
        c = counts()
        check_out(out, shape, unit=False)
        print(f"  {label}: {out['time'] * 1e3:.3f} ms (host clock, synchronised), "
              f"launches {c}")
        if any(c[k] != NAFNET_FUSED_BLOCKS for k in NAF):
            fail(f"{label}: K1/K2 launched other than {NAFNET_FUSED_BLOCKS} times: {c}")
        for k in NAF:
            total[k] += c[k]

    reset_counts()
    batches = list(pred.predict_iter(({"image": f} for f in frames), batch_size=2))
    if len(batches) != 1:
        fail(f"predict_iter made {len(batches)} batches of 2 same-shaped frames")
    served("nafnet_local 2x736x1280", batches[0][0], (2, 736, 1280, 3))
    for hw in ((720, 1280), (601, 803)):
        reset_counts()
        out = pred.infer({"image": gen.uniform(0, 1, (*hw, 3)).astype(np.float32)})
        served(f"nafnet_local {hw[0]}x{hw[1]}", out, (1, *hw, 3))
    return total


def phase_serve_restormer(gen) -> dict:
    """The Restormer path: a bf16 tiled Predictor (384x384 tiles, overlap
    32, chunks of up to 8) answers a 1080x1920 frame (padded to 1088x1920:
    18 tiles, 3 chunks of 6) and a 601x803 frame (608x808: 6 tiles, one
    chunk). Counts are reset before each request and read after it; every
    chunk-forward launches R1 and R2 44 times each. Returns their sum."""
    print("[serve] bf16 tiled Predictor, restormer at full width")
    pred = Predictor(build_model("restormer"), tile=TILE, bf16=True)
    total = dict.fromkeys(RST, 0)
    for hw, chunks in (((1080, 1920), 3), ((601, 803), 1)):
        x = gen.uniform(0, 1, (*hw, 3)).astype(np.float32)
        reset_counts()
        out = pred.infer({"image": x})
        torch.cuda.synchronize()
        c = counts()
        check_out(out, (1, *hw, 3), unit=False)
        print(f"  restormer {hw[0]}x{hw[1]}: {out['time'] * 1e3:.3f} ms (host clock, "
              f"synchronised), launches {c}")
        if any(c[k] != chunks * RESTORMER_BLOCKS for k in RST):
            fail(f"restormer {hw}: R1/R2 launched other than {chunks} x {RESTORMER_BLOCKS} "
                 f"times: {c}")
        for k in RST:
            total[k] += c[k]
    return total


def phase_serve_hinet(gen) -> None:
    """The HINet path (no kernel of its own): one tiled request with
    hinet_tiny_tiled's spec (tiles 32, overlap 8, uniform blend, each tile
    normalised by its own statistics) at the published width, float32; then
    the predict CLI (bf16) on three PNGs and the metric CLI on what it
    wrote against their targets (psnr, ssim, ms_ssim; then with
    --use-gt-mean and --save-csv)."""
    import csv
    import tempfile
    import cv2
    from enhax_torch.cli import metric as metric_cli
    from enhax_torch.cli import predict as predict_cli
    print("[serve] hinet_re at the published width")
    pred = Predictor(build_model("hinet_re"), tile=HINET_TILE, tile_blend="uniform")
    x = gen.uniform(0, 1, (240, 320, 3)).astype(np.float32)
    out = pred.infer({"image": x})
    check_out(out, (1, 240, 320, 3), unit=False)
    print(f"  hinet_re 240x320 tiled {HINET_TILE} uniform, float32: {out['time'] * 1e3:.3f} ms "
          "(host clock, synchronised)")
    del pred, out
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for d in ("data", "ref"):
            (root / d).mkdir()
        for i in range(3):
            ref = gen.integers(0, 256, (256, 320, 3), dtype=np.uint8)
            noisy = np.clip(ref + gen.normal(0, 12, ref.shape), 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / "ref" / f"{i:02d}.png"), ref)
            cv2.imwrite(str(root / "data" / f"{i:02d}.png"), noisy)
        t0 = time.perf_counter()
        predict_cli.main(["--model", "hinet_re", "--data", str(root / "data"), "--save-dir",
                          str(root / "out"), "--bf16"])
        print(f"  predict CLI, 3 PNGs of 256x320, bf16: {time.perf_counter() - t0:.1f} s")
        if sorted(p.name for p in (root / "out").iterdir()) != ["00.png", "01.png", "02.png"]:
            fail("the predict CLI did not write one image per input")
        base = ["--input", str(root / "out"), "--target", str(root / "ref")]
        res = metric_cli.main(base + ["--metric", "psnr", "--metric", "ssim",
                                      "--metric", "ms_ssim"])
        res_gt = metric_cli.main(base + ["--use-gt-mean", "--save-csv", str(root / "s.csv")])
        rows = list(csv.DictReader(open(root / "s.csv")))
        print(f"  metric CLI: {res}; --use-gt-mean: {res_gt}; CSV rows {rows}")
        if not (all(np.isfinite(v) for v in (*res.values(), *res_gt.values()))
                and list(res) == ["psnr", "ssim", "ms_ssim"] and len(rows) == 3):
            fail("the metric CLI's scores of the predict CLI's output are malformed")


# -- training ---------------------------------------------------------------------

SIDD_CONFIG = Path(__file__).resolve().parent / "configs" / "nafnet_sidd.py"
TRAIN_BATCH = (16, 256, 256, 3)    # bench_train.py:204, nafnet_sidd_256_b16
TRAIN_SHAPES = ((16, 256, 256, 32), (16, 128, 128, 64))
# fused against unfused, float32, TF32 off: the loss and each parameter's
# gradient within 1e-4 x max(1, max|ref|) per tensor (the backward is the
# same eager math; the forwards sum in another order)
TOL_TRAIN_F32 = 1e-4
# bf16-mixed: K1/K2 round g and the block's output to bf16 once, the
# module's bf16 forward after every op, so the two steps' gradients differ
# by bf16 roundings carried through 36 blocks: about 2e-2 on an H100
# (PERF.md), held to 5e-2
TOL_TRAIN_BF16 = 5e-2
TRAIN_STEPS, TRAIN_WARMUP = 10, 3


def sidd_train_model(gen):
    """NAFNet-SIDD at full width on the card, every param shifted and beta
    and gamma drawn (at their zero init every block is the identity)."""
    model = build_model("nafnet", device="cpu", seed=10)
    perturb(model.module, gen, 0.002, 0.2)
    return model.to("cuda")


def train_batch(gen, shape=TRAIN_BATCH) -> dict:
    ref = gen.uniform(0, 1, shape).astype(np.float32)
    img = np.clip(ref + gen.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return {"image": torch.from_numpy(img).cuda(), "ref_image": torch.from_numpy(ref).cuda()}


def step_grads(model, batch, **kw) -> tuple:
    """One train step with lr 0 (the params stay, each .grad keeps the
    step's gradient): loss, gradients and K1/K2 launches, counts reset just
    before and read just after."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import TrainState, make_train_step
    tx = build_optimizer({"optimizer": {"name": "adam", "lr": 0.0}})
    state = TrainState(0, model.module, tx.init(model.module.parameters()))
    step = make_train_step(model, tx, **kw)
    reset_counts()
    loss = step(state, batch)["loss"].item()
    c = counts()
    grads = {k: p.grad.detach().clone() for k, p in model.module.named_parameters()}
    model.module.zero_grad(set_to_none=True)
    return loss, grads, (c["k1_apply"], c["k2_apply"])


def grad_gap(grads: dict, ref: dict) -> float:
    """max over tensors of max|d| / max(1, max|ref|)."""
    return max((grads[k] - g).abs().max().item() / max(1.0, g.abs().max().item())
               for k, g in ref.items())


def write_pair_tree(root: Path, data: str, gen, n_train: int, n_test: int, hw: int) -> None:
    """root/<data>/{train,test}/{image,ref}: noisy and clean hw x hw PNG
    pairs of one name."""
    import cv2
    for split, n in (("train", n_train), ("test", n_test)):
        for sub in ("image", "ref"):
            (root / data / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            clean = gen.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
            noisy = np.clip(clean + gen.normal(0, 12, clean.shape), 0, 255).astype(np.uint8)
            cv2.imwrite(str(root / data / split / "image" / f"{i:04d}.png"), noisy)
            cv2.imwrite(str(root / data / split / "ref" / f"{i:04d}.png"), clean)


def train_cli_runs(gen) -> dict:
    """The train CLI end to end on a SIDD-shaped tree: --steps 6, then
    --steps 10 with ENHAX_FUSED_TRAIN=1, which resumes at step 6 from
    ``last``. Counts are reset before each run and read after it; K1/K2 run
    in each validation (the serving path, 8 a batch) and, in the fused run,
    16 times a train step (remat)."""
    import csv
    import os
    import tempfile
    from enhax_torch.cli import train as train_cli
    launches = dict.fromkeys(NAF, 0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_pair_tree(root / "data", "sidd", gen, 32, 4, 512)
        argv = ["--config", str(SIDD_CONFIG), "--root", str(root / "data"),
                "--save-dir", str(root / "run")]
        # 32 pairs in batches of 8: 4 steps an epoch; the first run stops in
        # its second epoch (2 validations), the second in its third (1)
        for steps, fused, want in ((6, False, 2 * 8), (10, True, 4 * 16 + 8)):
            if fused:
                os.environ["ENHAX_FUSED_TRAIN"] = "1"
            t0 = time.perf_counter()
            reset_counts()
            try:
                state = train_cli.main(argv + ["--steps", str(steps)])
            finally:
                os.environ.pop("ENHAX_FUSED_TRAIN", None)
            torch.cuda.synchronize()
            c = counts()
            ckpt = torch.load(root / "run" / "ckpt" / "last" / "state.pt", map_location="cpu",
                              weights_only=True)
            rows = list(csv.DictReader(open(root / "run" / "log.csv")))
            print(f"  train CLI --steps {steps}{' ENHAX_FUSED_TRAIN=1' if fused else ''}: "
                  f"{time.perf_counter() - t0:.1f} s, ended at step {state.step}, last "
                  f"checkpoint at step {ckpt['step']}, launches {c}, log {rows}")
            if state.step != steps or ckpt["step"] != steps:
                fail(f"the train CLI ended at step {state.step}, checkpoint {ckpt['step']}")
            if not (root / "run" / "ckpt" / "best" / "state.pt").is_file() or not rows:
                fail("the train CLI wrote no best checkpoint or no CSV log")
            if not all(np.isfinite(float(r[k])) for r in rows for k in r if "/" in k):
                fail(f"a logged value is not finite: {rows}")
            if any(c[k] != want for k in NAF):
                fail(f"the train CLI run launched K1/K2 {c}, expected {want} each")
            if fused and int(rows[0]["epoch"]) != 2:
                fail("the second run did not resume in the epoch after the first")
            for k in NAF:
                launches[k] += c[k]
    return launches


def time_train_step(name: str, model, batch: dict, opt_cfg: dict, precision, fused: bool,
                    smi: str, remat: bool = True, ema_decay: float | None = 0.999,
                    clip: float | None = None) -> dict:
    """ms a step and train MP/s of the config's step (NAFNet-SIDD's: remat,
    EMA 0.999), host clock over TRAIN_STEPS synchronised steps after
    TRAIN_WARMUP, peak memory; then one step under torch.profiler (the
    whole table to build/profiles/), split by the step's ranges."""
    from enhax_torch.train import Trainer
    tr = Trainer(model, opt_cfg, remat=remat, ema_decay=ema_decay, precision=precision,
                 fused_train=fused, gradient_clip_val=clip)
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        tr._train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = tr._train_step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(metrics["loss"]).item():
        fail(f"train step {name}: loss not finite")
    averages, table, device_ms = profiled(lambda: tr._train_step(state, batch),
                                          f"train_{name}")
    split = {e.key: e.device_time_total / 1e3 for e in averages
             if e.key.startswith(("train_step.", "nafblock_fused."))
             and e.device_type == torch.autograd.DeviceType.CPU}
    naf = {e.key: e.self_device_time_total / 1e3 for e in averages
           if e.device_type == torch.autograd.DeviceType.CUDA
           and re.search(r"\bk[12]_(bf16_)?kernel<", e.key)}
    b, h, w, _ = batch["image"].shape
    row = {"ms_per_step": dt * 1e3, "train_mp_per_s": b * h * w / 1e6 / dt,
           "peak_gib": peak / 2**30, "device_ms": device_ms, "ranges_device_ms": split,
           "nafblock_kernels_device_ms": naf}
    print(f"  {name}: {dt * 1e3:.3f} ms a step (host clock over {TRAIN_STEPS} synchronised "
          f"steps), {row['train_mp_per_s']:.3f} train MP/s, peak {peak / 2**30:.2f} GiB; "
          f"profiled step: device {device_ms:.3f} ms, ranges {split}, K1/K2 {naf}; {smi}")
    print("\n".join(table.splitlines()[:14]))
    return row


def phase_train(gen, smi: str) -> dict:
    """NAFNet-SIDD training on the card (configs/nafnet_sidd.py's model and
    optimizer at bench_train.py's batch of 16 x 256 x 256): K1/K2 at the
    training shapes against their plain versions; a fused step's loss and
    gradients against the unfused step's (TF32 off; float32 and bf16-mixed,
    remat off and on) with K1/K2 launches counted per step (8 / 16 fused,
    none unfused, 8 an eval step); the prepared weights once a step; the
    train CLI run twice, the second resuming; then the four variants timed.
    Returns the K1/K2 launches of the steps and runs it counted."""
    from enhax_torch.kernels import _launch
    from enhax_torch.train import make_eval_step
    from enhax_torch.utils.config import load_config
    t_phase = time.perf_counter()
    print("[train] NAFNet-SIDD, configs/nafnet_sidd.py, 16x256x256")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRAIN_SHAPES:
            c = shape[-1]
            p = block_params(c, dtype, gen)
            x = rand(gen, shape, -1, 1, dtype)
            compare("k1_apply", (x, p), {})
            with torch.inference_mode():
                g = nafblock.k1_plain(x, p)
            compare("k2_apply", (x, g, g.mean(dim=(1, 2), keepdim=True), p), {})
            del p, x, g
    launches = dict.fromkeys(NAF, 0)
    model = sidd_train_model(gen)
    batch = train_batch(gen)
    gaps = {}
    for precision, tol in ((None, TOL_TRAIN_F32), ("bf16-mixed", TOL_TRAIN_BF16)):
        for remat in (False, True):
            kw = {"remat": remat, "precision": precision}
            loss_ref, ref, l_ref = step_grads(model, batch, **kw)
            loss, grads, l_fused = step_grads(model, batch, fused=True, **kw)
            gap = grad_gap(grads, ref)
            loss_gap = abs(loss - loss_ref) / max(1.0, abs(loss_ref))
            label = f"{precision or 'float32'} remat={remat}"
            gaps[label] = {"loss": loss_gap, "grad": gap}
            print(f"  fused vs unfused, {label}: loss {loss:.6f} / {loss_ref:.6f} "
                  f"(gap {loss_gap:.3e}), gradients max|d|/max(1, max|ref|) {gap:.3e} "
                  f"(tol {tol}); K1/K2 launches fused {l_fused}, unfused {l_ref}")
            want = 16 if remat else 8
            if l_ref != (0, 0) or l_fused != (want, want):
                fail(f"{label}: K1/K2 launched {l_fused} fused, {l_ref} unfused; "
                     f"expected {want} and 0")
            if not (loss_gap <= tol and gap <= tol):
                fail(f"{label}: the fused step's loss or gradients disagree with the unfused")
            for k, n in zip(NAF, l_fused):
                launches[k] += n
            del ref, grads
    reset_counts()
    metrics = make_eval_step(model)(model.module, batch)
    c = counts()
    print(f"  eval step: {({k: round(v.item(), 4) for k, v in metrics.items()})}, launches {c}")
    if any(c[k] != NAFNET_FUSED_BLOCKS for k in NAF):
        fail(f"the eval step launched K1/K2 {c}")
    for k in NAF:
        launches[k] += c[k]
    # the prepared weights: a bf16-mixed step makes new bf16 copies, so
    # each of 8 blocks prepares K1's and K2's anew, once, the remat
    # recompute reusing them
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import TrainState, make_train_step
    tx = build_optimizer(load_config(SIDD_CONFIG)["optimizer_cfg"])
    state = TrainState(0, model.module, tx.init(model.module.parameters()))
    step = make_train_step(model, tx, remat=True, precision="bf16-mixed", fused=True)
    made = []
    for _ in range(2):
        before = _launch.prepared.makes
        step(state, batch)
        made.append(_launch.prepared.makes - before)
    print(f"  prepared weights made a bf16-mixed fused step (remat): {made}")
    if made != [2 * NAFNET_FUSED_BLOCKS] * 2:
        fail(f"K1/K2 weights were prepared {made} times a step, expected 16 each")
    del model, batch, state, step
    torch.cuda.empty_cache()

    cli = train_cli_runs(gen)
    for k in NAF:
        launches[k] += cli[k]

    # timing: the config's step (remat, EMA) as a user runs it: torch's
    # default TF32 flags (cuDNN convs in TF32, matmuls in float32)
    opt_cfg = load_config(SIDD_CONFIG)["optimizer_cfg"]
    timing = {"card": smi, "batch": list(TRAIN_BATCH), "remat": True, "ema_decay": 0.999,
              "cudnn_allow_tf32": True, "matmul_allow_tf32": False, "steps": TRAIN_STEPS,
              "warmup": TRAIN_WARMUP}
    with default_tf32():
        for precision in (None, "bf16-mixed"):
            for fused in (False, True):
                name = f"{precision or 'float32'}_{'fused' if fused else 'unfused'}"
                gc.collect()
                timing[name] = time_train_step(name, sidd_train_model(gen), train_batch(gen),
                                               opt_cfg, precision, fused, smi)
                torch.cuda.empty_cache()
    timing["fused_vs_unfused"] = gaps
    timing["phase_s"] = time.perf_counter() - t_phase
    print(f"  train phase: {timing['phase_s']:.1f} s")
    return {"launches": launches, "timing": timing}


GOPRO_CONFIG = Path(__file__).resolve().parent / "configs" / "hinet_gopro.py"
ZERO_DCEPP_CONFIG = Path(__file__).resolve().parent / "configs" / "zero_dcepp_re_sice_mix.py"
ZERO_DCE_CONFIG = Path(__file__).resolve().parent / "configs" / "zero_dce_re_sice_mix.py"
HINET_TRAIN_BATCH = (16, 256, 256, 3)     # bench_train.py:203,208, hinet_gopro_256_b16
ZERO_DCE_TRAIN_BATCH = (8, 256, 256, 3)   # bench_train.py:202, zero_dce_256_b8
ZERO_DCE_VAL_BATCH = (2, 512, 512, 3)     # the train CLI's validation: 2 test pairs of 512


def train_cli_run(config: Path, data: str, gen, steps: int, hw: int, fused: bool) -> dict:
    """The train CLI on ``config`` as it is over a generated ``data`` tree
    (16 train pairs, 2 test pairs of hw x hw): ``--steps`` steps and one
    validation. Counts are reset just before the run and read just after."""
    import os
    import tempfile
    from enhax_torch.cli import train as train_cli
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_pair_tree(root / "data", data, gen, 16, 2, hw)
        if fused:
            os.environ["ENHAX_FUSED_TRAIN"] = "1"
        t0 = time.perf_counter()
        reset_counts()
        try:
            state = train_cli.main(["--config", str(config), "--root", str(root / "data"),
                                    "--save-dir", str(root / "run"), "--steps", str(steps)])
        finally:
            os.environ.pop("ENHAX_FUSED_TRAIN", None)
        torch.cuda.synchronize()
        c = counts()
        import csv
        rows = list(csv.DictReader(open(root / "run" / "log.csv")))
    print(f"  train CLI {config.name}{' ENHAX_FUSED_TRAIN=1' if fused else ''} --steps {steps}: "
          f"{time.perf_counter() - t0:.1f} s, ended at step {state.step}, launches "
          f"{ {k: v for k, v in c.items() if v} }, log {rows}")
    if state.step != steps or len(rows) != 1:
        fail(f"the train CLI on {config.name} ended at step {state.step}, {len(rows)} epochs")
    if not all(np.isfinite(float(r[k])) for r in rows for k in r if "/" in k):
        fail(f"a logged value is not finite: {rows}")
    return c


def phase_train_hinet_zero_dce(gen, smi: str) -> dict:
    """HINet and Zero-DCE training on the card: hinet_re at the published
    width at bench_train.py's 16x256x256 with configs/hinet_gopro.py's Adam
    and restart schedule, float32 and bf16-mixed, unfused (the model has no
    fused path); zero_dce_re at 8x256x256 in float32 with its config's Adam
    (weight decay 1e-5) and the gradient norm clipped to 0.1: no curve
    kernel in the timed train steps, one fused_curve_apply launch in an eval
    step. Each timed as the NAFNet rows (torch's default TF32 flags).
    fused_curve_apply against its plain version in float32 at the shapes
    this path gives it (the eval step's, the Zero-DCE++ CLI validation's).
    Then the train CLI on configs/hinet_gopro.py with ENHAX_FUSED_TRAIN=1
    (the module trains) and on configs/zero_dcepp_re_sice_mix.py, with the
    curve kernel's launches in their validation. Returns the curve kernels'
    launches of the steps and runs counted, the timing rows and the
    kernel's max|d| at those shapes."""
    from enhax_torch.train import make_eval_step
    from enhax_torch.utils.config import load_config
    t_phase = time.perf_counter()
    print("[train] hinet_re (configs/hinet_gopro.py) 16x256x256; zero_dce_re "
          "(configs/zero_dce_re_sice_mix.py) 8x256x256")
    launches = dict.fromkeys(DCE, 0)
    timing = {"card": smi, "cudnn_allow_tf32": True, "matmul_allow_tf32": False,
              "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP}
    gopro, cfg = load_config(GOPRO_CONFIG), load_config(ZERO_DCE_CONFIG)
    clip = cfg["trainer_cfg"]["gradient_clip_val"]
    with default_tf32():
        for precision in (None, "bf16-mixed"):
            name = f"hinet_{precision or 'float32'}"
            gc.collect()
            timing[name] = time_train_step(
                name, build_model("hinet_re", seed=10, **gopro["model_cfg"]),
                train_batch(gen, HINET_TRAIN_BATCH), gopro["optimizer_cfg"], precision,
                False, smi, remat=False, ema_decay=None)
            torch.cuda.empty_cache()
        model = build_model("zero_dce_re", seed=10)
        batch = {"image": rand(gen, ZERO_DCE_TRAIN_BATCH, 0, 0.3, torch.float32)}
        gc.collect()
        reset_counts()
        timing["zero_dce_re_float32"] = time_train_step(
            "zero_dce_re_float32", model, batch, cfg["optimizer_cfg"], None, False, smi,
            remat=False, ema_decay=None, clip=clip)
        c_train = {k: counts()[k] for k in DCE}
        reset_counts()
        metrics = make_eval_step(model)(model.module, batch)
        c_eval = {k: counts()[k] for k in DCE}
    print(f"  zero_dce_re: curve launches in {TRAIN_WARMUP + TRAIN_STEPS + 1} train steps "
          f"{c_train}, in an eval step {c_eval}, eval "
          f"{({k: round(v.item(), 5) for k, v in metrics.items()})}")
    if any(c_train.values()) or c_eval != {DCE[0]: 0, DCE[1]: 1}:
        fail("zero_dce_re: expected no curve kernel in a train step and one "
             "fused_curve_apply in an eval step")
    launches[DCE[1]] += c_eval[DCE[1]]
    timing["zero_dce_re_curve_launches"] = {"train_step": 0, "eval_step": 1}
    del model, batch
    torch.cuda.empty_cache()

    # fused_curve_apply at the shapes this path gives it, float32: the eval
    # step's (8,256,256,3) with 24 curves, the Zero-DCE++ CLI's validation
    # batch with a shared curve
    kgen = np.random.default_rng(14)
    err = 0.0
    for shape, rc, shared in ((ZERO_DCE_TRAIN_BATCH, 24, False), (ZERO_DCE_VAL_BATCH, 3, True)):
        x = rand(kgen, shape, 0, 0.3, torch.float32)
        r = rand(kgen, (*shape[:3], rc), -1, 1, torch.float32)
        err = max(err, compare(DCE[1], (x, r), {"num_iters": 8, "shared": shared}))
    del x, r

    # the train CLI: 16 pairs, batches of 8, 2 steps and one validation each
    c = train_cli_run(GOPRO_CONFIG, "gopro", gen, 2, 320, fused=True)
    if any(c.values()):
        fail(f"the HINet train CLI launched a kernel: {c}")
    c = train_cli_run(ZERO_DCEPP_CONFIG, "sice_mix", gen, 2, ZERO_DCE_VAL_BATCH[1],
                      fused=False)
    others = {k: v for k, v in c.items() if k != DCE[1] and v}
    print(f"  zero_dce++_re validation: fused_curve_apply launched {c[DCE[1]]} times "
          "(one val batch)")
    if c[DCE[1]] != 1 or others:
        fail(f"the Zero-DCE++ train CLI launched {c}; expected one fused_curve_apply (its "
             "validation batch) and nothing else")
    launches[DCE[1]] += c[DCE[1]]
    timing["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase: {timing['phase_s']:.1f} s")
    return {"launches": launches, "timing": timing, "errs": {DCE[1]: err}}


LEVEL_NAMES = ("enc0", "dec0+refinement", "enc1/dec1", "enc2/dec2", "latent")


def phase_probes(gen) -> tuple[dict, dict]:
    """The slice's serving path at full width: one 1080x1920 frame (bf16
    inside the model, the blend in float32 as ``Predictor`` runs it) through
    ``tiled_apply_batched`` (tiles 384, overlap 32, chunks of 8: 18 tiles, 3
    chunks of 6) with every block in its tap-folded form, then the default
    path on the same frame, in turns (folded, default, folded, default; the
    first folded request is the counted one). Then the three probes at their
    JAX shapes and the dw_mxu A/B at every chunk level. Returns (launches,
    results): R1-mxu/R2-mxu counted over the folded request, the dw 3x3 over
    the dw probe, the GELU over the GELU probe."""
    print("[probes] restormer 1080x1920 tiled 384, dw_mxu blocks vs default, bf16")
    net = build_model("restormer", dtype=torch.bfloat16).module
    frame = torch.from_numpy(gen.uniform(0, 1, (1, 1080, 1920, 3)).astype(np.float32)).cuda()
    paths = {
        "dw_mxu": lambda t: mxu_forward(net, t.to(torch.bfloat16))["enhanced"].float(),
        "default": lambda t: rb.restormer_fast_apply(net, t.to(torch.bfloat16))["enhanced"].float(),
    }

    def request(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tiled_apply_batched(paths[name], frame, tile=TILE[:2], overlap=TILE[2], chunk=8)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    times = {"dw_mxu": [], "default": []}
    with torch.inference_mode():
        request("default")  # first request: cuDNN picks its algorithms
        reset_counts()
        out_m, dt = request("dw_mxu")
        c = counts()
        times["dw_mxu"].append(dt)
        print(f"  dw_mxu request: launches {c}")
        if any(c[k] != 3 * RESTORMER_BLOCKS for k in MXU) or any(c[k] for k in RST):
            fail(f"the dw_mxu frame launched R1-mxu/R2-mxu other than 3 x {RESTORMER_BLOCKS} "
                 f"times, or the default R1/R2: {c}")
        launches = {k: c[k] for k in MXU}
        out_d, dt = request("default")
        times["default"].append(dt)
        for name in ("dw_mxu", "default"):
            times[name].append(request(name)[1])
    for out in (out_m, out_d):
        check_out({"enhanced": out}, (1, 1080, 1920, 3), unit=False)
    diff = (out_m - out_d).abs().max().item()
    print(f"  1080x1920 request (host clock, synchronised): dw_mxu "
          f"{' / '.join(f'{t:.4f}' for t in times['dw_mxu'])} s, default "
          f"{' / '.join(f'{t:.4f}' for t in times['default'])} s; max|d| between them "
          f"{diff:.3e} (bf16 blocks, max|out| {out_d.abs().max().item():.3f})")
    del out_m, out_d
    results = {"frame_1080p": {"dw_mxu_s": times["dw_mxu"], "default_s": times["default"],
                               "max_abs_diff": diff}}

    print("[probes] enhax_torch.probes at their JAX shapes")
    device = torch.device("cuda")
    reset_counts()
    results["dw_roofline"] = [r for c in (288, 512)
                              for r in probe_dw_roofline.cases(15, 256, c, device)]
    launches["dw3x3_apply"] = dw3x3.dw3x3_apply.launches
    reset_counts()
    results["gelu_kernel"] = probe_gelu.standalone(device) + probe_gelu.fused(device)
    launches["gelu_apply"] = gelu.gelu_apply.launches
    results["dw_mxu"] = [probe_dw_mxu.ab(shape, heads, level, device)
                         for shape, heads, level in probe_dw_mxu.SHAPES]
    results["dw_mxu"] += [probe_dw_mxu.ab(shape, heads, f"chunk {name}", device, iters=5)
                          for (shape, heads), name in zip(RESTORMER_LEVELS, LEVEL_NAMES)]
    for key in ("dw_roofline", "gelu_kernel", "dw_mxu"):
        for row in results[key]:
            print(f"  {key}: {json.dumps(row)}")
    print(f"  launches: {launches}")
    return launches, results


def phase_bench_restormer() -> dict:
    """bench_all.py's restormer_1080p_tiled384_bf16_mf: four 1088x1920
    frames, 384x384 tiles, overlap 32, chunks of 8 (72 tiles, 9 chunks),
    bf16, through the tiled Predictor. The Predictor's own time (host clock,
    synchronised) of one request after a warm-up request, peak memory, then
    one request under torch.profiler (the whole table goes to
    build/profiles/). If the warm-up request takes over 10 s, one frame is
    timed instead."""
    print("[bench] restormer 4x1088x1920, tiles 384, overlap 32, chunks of 8, bf16")
    pred = Predictor(build_model("restormer"), tile=TILE, bf16=True)
    frames = np.random.default_rng(2).uniform(0, 1, (4, 1088, 1920, 3)).astype(np.float32)
    warm = pred.infer({"image": frames})
    check_out(warm, frames.shape, unit=False)
    print(f"  warm-up request: {warm['time']:.3f} s")
    if warm["time"] > 10:
        frames = frames[:1]
        print("  over 10 s: timing one frame (18 tiles, 3 chunks of 6) instead")
    del warm
    torch.cuda.reset_peak_memory_stats()
    out = pred.infer({"image": frames})
    check_out(out, frames.shape, unit=False)
    dt = out["time"]
    del out
    n = frames.shape[0]
    mps = n * 1088 * 1920 / 1e6 / dt
    peak = torch.cuda.max_memory_allocated()
    print(f"  {mps:.3f} MP/s, {dt:.3f} s per request of {n} frame(s) (host clock, "
          f"synchronised), peak memory {peak / 2**30:.3f} GiB")
    _, table, _ = profiled(lambda: pred.infer({"image": frames}), "restormer_bfloat16")
    print("\n".join(table.splitlines()[:22] + table.splitlines()[-3:]))
    return {"frames": n, "mp_per_s": mps, "s_per_request": dt, "peak_bytes": peak}


def phase_bench() -> dict:
    """bench.py's workload; returns throughput and peak memory. One more
    chunk then runs under torch.profiler for the device time by operator."""
    print("[bench] 48x1088x1920 uint8, zero_dce++_re sf=8, bf16, uint8 out")
    batch, h, w = 48, 1088, 1920
    model = build_model("zero_dce++_re", scale_factor=8.0, dtype=torch.bfloat16)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 77, (batch, h, w, 3), dtype=np.uint8)).cuda()

    def fwd(u8):
        x = u8.to(torch.bfloat16) / 255.0
        y = model.apply({"image": x})["enhanced"]
        return (y.float() * 255.0).round().clamp(0, 255).to(torch.uint8)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode():
        out = fwd(frames)
        torch.cuda.synchronize()
        if not (out.shape == frames.shape and out.float().mean().item() > 0):
            fail("bench output malformed")
        del out
        n_chunks = 24
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            out = fwd(frames)
            del out
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n_chunks
    mps = batch * h * w / 1e6 / dt
    peak = torch.cuda.max_memory_allocated()
    paths = up_paths()
    print(f"  {mps:.2f} MP/s, {dt * 1e3:.3f} ms per chunk (host clock over "
          f"{n_chunks} chunks), peak memory {peak / 2**30:.3f} GiB; upsample paths over "
          f"the {n_chunks + 1} chunks {paths}")
    if paths != {"general": 0, "vec": n_chunks + 1}:
        fail(f"a bench chunk did not take the upsample's vec path: {paths}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        fwd(frames)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=60))
    return {"mp_per_s": mps, "ms_per_chunk": dt * 1e3, "peak_bytes": peak}


def phase_bench_nafnet(dtype) -> dict:
    """NAFNet-TLC at bench_all.py's 3b shape: 2x736x1280 through
    ``Model.apply`` (the fused path) in ``dtype``. Host clock over 12
    synchronised batches after a warm-up, peak memory, then one batch under
    torch.profiler (the whole table goes to build/profiles/)."""
    name = str(dtype)[6:]
    print(f"[bench] 2x736x1280, nafnet_local, {name}")
    model = build_model("nafnet_local", dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 736, 1280, 3)).astype(np.float32)).to("cuda", dtype)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = model.apply({"image": x})["enhanced"]
        torch.cuda.synchronize()
        if out.shape != x.shape or not torch.isfinite(out).all():
            fail("nafnet bench output malformed")
        del out
        n = 12
        t0 = time.perf_counter()
        for _ in range(n):
            model.apply({"image": x})
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
    mps = 2 * 736 * 1280 / 1e6 / dt
    peak = torch.cuda.max_memory_allocated()
    print(f"  {mps:.2f} MP/s, {dt * 1e3:.3f} ms per batch (host clock over {n} "
          f"batches), peak memory {peak / 2**30:.3f} GiB")
    with torch.inference_mode():
        _, table, device_ms = profiled(lambda: model.apply({"image": x}), f"nafnet_{name}")
    print("\n".join(table.splitlines()[:22] + table.splitlines()[-3:]))
    print(f"  device time {device_ms:.3f} ms in the profiled batch beside {dt * 1e3:.3f} ms "
          f"a batch on the host clock")
    return {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "device_ms": device_ms,
            "peak_bytes": peak}


def phase_bench_hinet(dtype) -> tuple[dict, dict]:
    """hinet_re at bench_all.py's 2x736x1280 through a ``Predictor``
    (``bf16=`` for bfloat16; float32 with TF32 off, as the NAFNet row):
    host clock over 4 synchronised batches after a warm-up, the Predictor's
    own forward time, peak memory, then one batch under torch.profiler (the
    whole table to build/profiles/; its device time beside the host clock).
    Returns the row and the warm-up batch's outputs, on the CPU."""
    name = str(dtype)[6:]
    print(f"[bench] 2x736x1280, hinet_re, {name}, through the Predictor")
    pred = Predictor(build_model("hinet_re"), bf16=dtype == torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 736, 1280, 3)).astype(np.float32)).cuda()
    out = pred.infer({"image": x})
    check_out(out, tuple(x.shape), unit=False)
    out = {k: out[k].cpu() for k in ("stage1", "enhanced")}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    n, fwd = 4, []
    t0 = time.perf_counter()
    for _ in range(n):
        fwd.append(pred.infer({"image": x})["time"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    _, table, device_ms = profiled(lambda: pred.infer({"image": x}), f"hinet_{name}")
    print("\n".join(table.splitlines()[:16] + table.splitlines()[-3:]))
    mps = 2 * 736 * 1280 / 1e6 / dt
    print(f"  {mps:.3f} MP/s, {dt * 1e3:.3f} ms per batch (host clock over {n} batches; the "
          f"Predictor's forward {np.mean(fwd) * 1e3:.3f} ms), peak memory "
          f"{peak / 2**30:.3f} GiB; device time {device_ms:.3f} ms in the profiled batch")
    return {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "forward_ms": float(np.mean(fwd)) * 1e3,
            "device_ms": device_ms, "peak_bytes": peak}, out


def hinet_bf16_gap(out: dict, ref: dict) -> dict:
    """The bf16 Predictor's outputs of the bench batch against the float32
    Predictor's (the same weights): max|d| within TOL_HINET_BF16 x max(1,
    max|ref|) for each, and the mean |d|."""
    gaps = {}
    for key in ("stage1", "enhanced"):
        d = (out[key] - ref[key]).abs()
        scale = max(1.0, ref[key].abs().max().item())
        gaps[key] = {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
                     "max_abs_ref": ref[key].abs().max().item()}
        print(f"  hinet_re 2x736x1280 bf16 vs float32 {key}: max|d|={gaps[key]['max_abs']:.4e} "
              f"(tol {TOL_HINET_BF16 * scale:.4e}), mean|d|={gaps[key]['mean_abs']:.4e}, "
              f"max|ref|={gaps[key]['max_abs_ref']:.4f}")
        if not gaps[key]["max_abs"] <= TOL_HINET_BF16 * scale:
            fail(f"hinet_re's bf16 serving disagrees with its float32 serving ({key})")
    return gaps


def bound(nbytes: int, flops: int, mm_flops: int = 0,
          mm_rate: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time: bytes over the memory rate, or elementwise float32
    operations over the f32 rate plus matmul operations over ``mm_rate``
    (the tensor cores' for bf16 operands), whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = (flops / F32_FLOPS_PER_S + mm_flops / mm_rate) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes_of(*items) -> int:
    """Bytes of the tensors given, or of the tensors in a params dict."""
    total = 0
    for it in items:
        for t in (it.values() if isinstance(it, dict) else (it,)):
            total += t.numel() * t.element_size()
    return total


def phase_timing(gen, probes: dict) -> dict:
    """Kernel and plain-version times by CUDA events at the main path's
    shapes, in turns (plain, kernel, kernel, plain); the dw 3x3 and the GELU
    beside their library call from the probe phase's turns
    (``timing_beside_library``). Bytes count each input (params included)
    read once and the output written once. Returns the first case of each
    kernel (the one the kernels line reports)."""
    print("[timing] CUDA events, main-path shapes, bfloat16")
    bf = torch.bfloat16
    x = rand(gen, (48, 1088, 1920, 3), 0, 0.3, bf)
    r = rand(gen, (48, 136, 240, 3), -1, 1, bf)
    xr = rand(gen, (1, 1088, 1920, 3), 0, 0.3, bf)
    rr = rand(gen, (1, 1088, 1920, 24), -1, 1, bf)
    # (kernel, args, kwargs, bytes, elementwise f32 flops, matmul flops);
    # DCE: interpolation (~12) plus 3 per iteration an element, or 3 per
    # iteration. K1 a pixel: LayerNorm ~7C, taps 36C, gate C; 1x1 4C^2.
    # K2: ~13C elementwise; 1x1s 10C^2 (SCA on the TLC mean of every pixel,
    # conv3, conv4 C->2C, conv5). Their matmul operands are bf16.
    cases = [
        ("fused_curve_upsample_apply", (x, r), {"num_iters": 8, "scale": 8},
         nbytes_of(x, r, x), x.numel() * (12 + 3 * 8), 0),
        ("fused_curve_apply", (xr, rr), {"num_iters": 8, "shared": False},
         nbytes_of(xr, rr, xr), xr.numel() * 3 * 8, 0),
    ]
    for shape in ((2, 736, 1280, 32), (2, 368, 640, 64)):
        c = shape[-1]
        px = shape[0] * shape[1] * shape[2]
        p = block_params(c, bf, gen)
        xn = rand(gen, shape, -1, 1, bf)
        with torch.inference_mode():
            g = nafblock.k1_plain(xn, p)
            tlc = nafblock.box_mean_fast(g, 128)
        k1p = {k: p[k] for k in nafblock.K1_KEYS}
        k2p = {k: p[k] for k in nafblock.K2_KEYS}
        cases.append(("k1_apply", (xn, p), {}, nbytes_of(xn, k1p, xn), px * 44 * c,
                      px * 4 * c * c))
        cases.append(("k2_apply", (xn, g, tlc, p), {}, nbytes_of(xn, g, tlc, k2p, xn),
                      px * 13 * c, px * 10 * c * c))
        print(f"  nafblock {shape}: forms {nafblock.design(c, bf)}")
    # R1 and R2 and their tap-folded forms at the chunk shapes of all five
    # levels; R2 takes the plain R1's v and the glue's attention. R1 a
    # pixel: LayerNorm ~7C, taps 54C, squares 4C; qkv 6C^2 and the gram
    # 2C*hd. R2: LayerNorm and residuals ~9C, taps 36h, gate ~30h; attn @ v
    # 2C*hd, project_out 2C^2, the GDFN's 1x1s 6Ch.
    for level, (shape, heads) in enumerate(RESTORMER_LEVELS):
        b, h, w, c = shape
        px, hd = b * h * w, c // heads
        p = restormer_params(c, heads, bf, gen)
        hid = p["ffn.project_out.weight"].shape[1]
        xr = rand(gen, shape, -1, 1, bf)
        with torch.inference_mode():
            v, gram, qss, kss = rb.r1_plain(xr, p)
            attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], bf)
        r1p = {k: p[k] for k in rb.R1_KEYS}
        r2p = {k: p[k] for k in rb.R2_KEYS}
        resident, tile = rb.r1_geometry(1, c, heads, False)
        blocks = rb.r1_grid(resident, b, heads, rb.r1_tiles(h, w, tile)) * b * heads
        print(f"  {LEVEL_NAMES[level]} {shape} heads={heads}: forms {rb.design(1, c, heads)}; "
              f"R1 grid {blocks} blocks of {tile[0]}x{tile[1]} tiles on {resident} resident "
              f"({-(-blocks // resident)} wave(s))")
        resident_m, tile_m = rb.r1_geometry(1, c, heads, True)
        blocks_m = rb.r1_grid(resident_m, b, heads, rb.r1_tiles(h, w, tile_m)) * b * heads
        print(f"    mxu forms {rb.design(1, c, heads, mxu=True)}; R1-mxu grid {blocks_m} blocks "
              f"of {tile_m[0]}x{tile_m[1]} tiles on {resident_m} resident")
        if blocks > resident or blocks_m > resident_m:
            fail(f"R1 or R1-mxu at {shape} runs more blocks than are resident: more than a wave")
        cases.append(("r1_apply", (xr, p), {}, nbytes_of(xr, r1p, v, gram, qss, kss),
                      px * 65 * c, px * (6 * c * c + 2 * c * hd)))
        cases.append(("r2_apply", (xr, v, attn, p), {}, nbytes_of(xr, v, attn, r2p, xr),
                      px * (9 * c + 66 * hid), px * (2 * c * hd + 2 * c * c + 6 * c * hid)))
        # the tap-folded forms: no taps; R1-mxu's qkv 54C^2 (K = 9C), LayerNorm
        # and squares ~11C; R2-mxu's project_in 36Ch, LayerNorm, residuals and
        # gate ~9C + 30h
        cases.append(("r1_mxu_apply", (xr, p), {}, nbytes_of(xr, r1p, v, gram, qss, kss),
                      px * 11 * c, px * (54 * c * c + 2 * c * hd)))
        cases.append(("r2_mxu_apply", (xr, v, attn, p), {}, nbytes_of(xr, v, attn, r2p, xr),
                      px * (9 * c + 30 * hid),
                      px * (2 * c * hd + 2 * c * c + 36 * c * hid + 2 * hid * c)))
    res = {}
    with torch.inference_mode():
        for name, args, kw, nbytes, flops, mm_flops in cases:
            k = KERNELS[name]
            b_ms, b_by = bound(nbytes, flops, mm_flops, BF16_TC_FLOPS_PER_S)
            p1 = cuda_ms(lambda: k["plain"](*args, **kw), iters=3, warmup=1)
            k1 = cuda_ms(lambda: k["wrapper"](*args, **kw), iters=8)
            k2 = cuda_ms(lambda: k["wrapper"](*args, **kw), iters=8)
            p2 = cuda_ms(lambda: k["plain"](*args, **kw), iters=3, warmup=1)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            f32_ms = (flops + mm_flops) / F32_FLOPS_PER_S * 1e3
            print(f"  {name} {tuple(args[0].shape)} {kw}: kernel {k1:.4f} / {k2:.4f} ms, "
                  f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e9:.4f} GB; all flops at the f32 rate {f32_ms:.4f} ms), "
                  f"{b_ms / ms:.1%} of the bound")
            res.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "library_ms": None})
        upsample_turns(x, r, res["fused_curve_upsample_apply"]["bound_ms"])
        # float32, as a Predictor without bf16 sends it: the paths side by side
        g32 = np.random.default_rng(7)
        x32 = rand(g32, (4, 1088, 1920, 3), 0, 0.3, torch.float32)
        r32 = rand(g32, (4, 136, 240, 3), -1, 1, torch.float32)
        upsample_turns(x32, r32, bound(nbytes_of(x32, r32, x32), x32.numel() * (12 + 3 * 8))[0])
    res.update(timing_beside_library(gen, probes))
    return res


def upsample_turns(x: torch.Tensor, r: torch.Tensor, bound_ms: float) -> dict:
    """The upsample kernel at s=8 in 5 alternating turns of 20 launches:
    the "vec" path, the first design (the "general" path on the same
    inputs) and ``out.copy_(x)``, which moves the image in and the output
    out as the kernel does (all but the low-resolution curve, 1/64 of the
    image at s=8): median and range. The wrapper takes the path
    ``upsample_path`` names (printed)."""
    out = torch.empty_like(x)
    taken = dce_curve.upsample_path(x.shape, x.dtype, 8, x.data_ptr())
    fns = {"vec": lambda: dce_curve._upsample_launch(x, r, 8, 8, "vec"),
           "general": lambda: dce_curve._upsample_launch(x, r, 8, 8, "general"),
           "copy": lambda: out.copy_(x)}
    times = {k: spread(v) for k, v in turns(fns, iters=20, reps=5).items()}
    for k, v in times.items():
        print(f"  fused_curve_upsample_apply {tuple(x.shape)} turns, {k}: {v['ms']:.4f} ms "
              f"({v['ms_min']:.4f}-{v['ms_max']:.4f}), {bound_ms / v['ms']:.1%} of the "
              f"{bound_ms:.4f} ms bound")
    print(f"  vec / copy {times['vec']['ms'] / times['copy']['ms']:.3f}, general / vec "
          f"{times['general']['ms'] / times['vec']['ms']:.3f}; {x.dtype} takes {taken!r}")
    print(json.dumps({"upsample_turns": {"shape": list(x.shape), "dtype": str(x.dtype),
                                         "path": taken, "bound_ms": bound_ms, **times}}))
    return times


def timing_beside_library(gen, probes: dict) -> dict:
    """The dw 3x3 and the GELU at the probes' shapes: kernel and library
    call from the probe phase (5 alternating turns: median and range), the
    plain version timed here at the first case's shape. The dw 3x3 moves 4
    bytes an element (bf16 in and out) for 18 flops, the GELU 8 for ~30.
    Returns the rows of the kernels line: the dw 3x3 at C = 288,
    rows="zero", and the GELU with the A&S erf."""
    res = {}
    xd = rand(gen, (15, 256, 256, 288), -1, 1, torch.bfloat16)
    kd = rand(gen, (3, 3, 288), -1, 1, torch.bfloat16)
    xg = rand(gen, probe_gelu.SHAPE, -3, 3, torch.float32)
    plain = {}
    with torch.inference_mode():
        for name, args, kw in (("dw3x3_apply", (xd, kd), {"rows": "zero"}),
                               ("gelu_apply", (xg,), {"erf": "as"})):
            fn = KERNELS[name]["plain"]
            plain[name] = [cuda_ms(lambda: fn(*args, **kw), iters=3, warmup=1) for _ in range(2)]
    del xd, kd, xg
    for name, key, label in (("dw3x3_apply", "dw_roofline", "rows"),
                             ("gelu_apply", "gelu_kernel", "erf")):
        zero = {}
        rows = [row for row in probes[key] if "library_ms" in row]  # not the GELU probe's R2
        for row in rows:
            lib = (f", library {row['library_ms']:.4f} ms "
                   f"({row['library_ms_min']:.4f}-{row['library_ms_max']:.4f}): kernel / library "
                   f"{row['ms'] / row['library_ms']:.3f}" if row["library_ms"] else "")
            path = f" path={row['path']}" if "path" in row else ""
            print(f"  {name} {tuple(row['shape'])} {label}={row[label]}{path}: kernel "
                  f"{row['ms']:.4f} ms ({row['ms_min']:.4f}-{row['ms_max']:.4f}){lib}, x.copy_ "
                  f"{row['copy_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by bytes, "
                  f"{row['share_of_bound']:.1%} of the bound")
            if row[label] == "zero":
                zero[row["shape"][-1]] = row["ms"]
            elif row[label] == "edge":
                print(f"    edge / zero: {row['ms'] / zero[row['shape'][-1]]:.3f}")
        first = rows[0]
        n, c = int(np.prod(first["shape"])), first["shape"][-1]
        # bf16 x, out and taps; float32 x and out
        nbytes, flops = (4 * n + 18 * c, 18 * n) if name == "dw3x3_apply" else (8 * n, 30 * n)
        b_ms, b_by = bound(nbytes, flops)
        print(f"  {name} plain {' / '.join(f'{t:.4f}' for t in plain[name])} ms; bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.4f} GB)")
        res[name] = {"ms": first["ms"], "plain_ms": sum(plain[name]) / 2, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": first["library_ms"]}
    return res


def main() -> None:
    smi, kind = phase_device()
    gen = np.random.default_rng(0)
    # the kernel checks' blocks (NAFBlock, RestormerBlock) draw their initial
    # weights from torch's generator: seeded, every run checks the same ones.
    # R1-mxu's bf16 gram at (1, 1, 37, 384) goes over its bound on a few
    # other draws, as the plain version's float32 sum does against float64
    # (tests/test_torch_gpu.py::test_r1_mxu_bf16_gram_at_one_row_over_draws,
    # tools/r1_mxu_gram_sweep.py)
    torch.manual_seed(0)
    phase_build()
    errs = phase_kernels(gen)
    phase_model_vs_cpu(gen)
    launches = {**phase_serve(gen), **phase_serve_nafnet(gen), **phase_serve_restormer(gen)}
    with torch.random.fork_rng():
        phase_serve_hinet(np.random.default_rng(13))
    # the train phases draw from generators of their own and leave torch's
    # untouched, so the later phases check and time what they did before them
    with torch.random.fork_rng(devices=[]):
        train = phase_train(np.random.default_rng(10), smi)
        train_more = phase_train_hinet_zero_dce(np.random.default_rng(11), smi)
    for k in NAF:
        launches[k] += train["launches"][k]
    for k in DCE:
        launches[k] += train_more["launches"][k]
    errs[DCE[1]] = max(errs[DCE[1]], train_more["errs"][DCE[1]])
    train["timing"]["hinet_zero_dce"] = train_more["timing"]
    probe_launches, probes = phase_probes(gen)
    launches.update(probe_launches)
    # each bench phase starts after a full collection: the earlier phases'
    # garbage (the profiler's events above all) collected inside a timed
    # loop would read as host time
    gc.collect()
    bench = {"zero_dce++_re 48x1088x1920 bfloat16": phase_bench()}
    for dtype in (torch.bfloat16, torch.float32):
        gc.collect()
        bench[f"nafnet_local 2x736x1280 {str(dtype)[6:]}"] = phase_bench_nafnet(dtype)
    gc.collect()
    bench["restormer 4x1088x1920 tiled 384 bfloat16"] = phase_bench_restormer()
    hinet_out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gc.collect()
        bench[f"hinet_re 2x736x1280 {str(dtype)[6:]}"], hinet_out[dtype] = \
            phase_bench_hinet(dtype)
    bench["hinet_re 2x736x1280 bfloat16"]["vs_float32"] = hinet_bf16_gap(
        hinet_out[torch.bfloat16], hinet_out[torch.float32])
    timing = phase_timing(gen, probes)
    kernels = []
    for name, k in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[name],
                        "max_abs_err": errs[name], **timing[name]})
    print(json.dumps({"probes": probes}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"train": train["timing"]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
