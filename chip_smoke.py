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
     other way, which moves q and k (and the gram's rounded operands).
     R1/R2 (and R1-mxu/R2-mxu) also at the small Restormer's widths (8, 1),
     (16, 1), (32, 2), (64, 2) (the general forms in float32 and bf16),
     ragged and at the golden chain's (4, 64, 64, C) and (4, 32, 32, C);
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
     validation) over generated gopro and sice_mix trees; then
     (``phase_train_restormer``) configs/restormer_rain13k.py at the
     published width: a float32 step (1x64x64, remat, EMA, TF32 off) on the
     card against the CPU (loss, gradients, EMA shadow within 1e-4 x max(1,
     max|ref|); no R1/R2 in the step), the eval step on the EMA shadow at
     1x128x128 after each of three steps (R1 = R2 = 36, the shadow's
     weights prepared anew once a step, the fused forward against the
     shadow's module forward), the train CLI on a copy of the config with
     its progressive milestones cut to epochs 0-4 for 3 epochs (each
     epoch's crop and batch, R1/R2 in each validation, checkpoints, val/psnr),
     and the step timed at 8x128x128 and 1x384x384 in float32 and
     bf16-mixed;
  5c. the instance path (``phase_instance``): zero_dce_v
     (configs/zero_dce_v.py) through ``Predictor`` at 512x512, 1-, 3- and
     100-step fits against the CPU's (planted faults read against the
     100-step bound; the fit under torch's deterministic mode), one request
     of 100 steps timed (one fused_curve_apply a request, none in the fit),
     and the kernel at (1, 256, 256, 1) with 15 curves against its plain
     version and timed (an ``{"instance": ...}`` line); then
     (``phase_instance_models``) colie_re, zero_mie_ms, gcenet_instance,
     rrdnet_re, zsn2n and zid through ``Predictor`` at their shipped
     configurations (512x512; zid 128x128; a generated depth map for
     zero_mie_ms and gcenet_instance): each on the card against the CPU
     (f32, TF32 off: the clean forward, the first step's loss and
     gradients, a 3-step fit's loss and output, within 1e-4 x max(1,
     max|ref|); the fitted state with ZID's BatchNorm statistics and the
     Fourier matrix, each tensor's mean|d| within 1e-4 x max(1, mean|ref|)
     and every element within Adam's reach, 2 x 3 x lr), one full request
     of its instance_steps timed with its peak memory, fit_loss and output
     range (no kernel launched),
     and a profiled request of 10 steps (an ``{"instance_models": ...}``
     line);
  5d. the quality chains (``phase_quality``, run last, after phase 7):
     ``QUALITY.json``'s nine chains
     (``enhax_torch.quality``: from the JAX package's init, train on the
     golden set, the predict CLI, the metric CLI) on the card, float32 with
     TF32 off and deterministic algorithms: the card's rows meet
     tests/test_quality_artifact.py's bars (two that the JAX package's own
     chain does not keep under a 1e-7 change of its init are held at that
     chain's mean less 3 sd, ``QUALITY_JAX_FLOOR``), agree with the CPU on
     the same weights within 0.5 dB and 0.02 SSIM (the two instance chains
     fitted on the CPU after the card's chains) and after 3 epochs of
     training from the same init within 0.01 dB and 0.001 SSIM; the curve
     kernel, K1/K2 and R1/R2 at (8, 1) and (16, 1) launch in the chains'
     predicts, (32, 2) and (64, 2) in a 4x256x256 restormer_tiny request (a
     ``{"quality": ...}`` line);
  5e. Uformer-B (``phase_uformer``): ``uformer_b`` on the card against the
     CPU at 1x128x128 (float32, TF32 off, 1e-4 x max(1, max|ref|)), served at
     2x736x1280 in bf16 and float32 and a 16x128x128 train step, timed as
     the HINet rows, and the predict CLI once with --benchmark (a
     ``{"uformer": ...}`` line);
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
     both row modes of the dw 3x3 with the path each took, both erf forms);
     and R1/R2 at each narrow width at (4, 64, 64, C) in float32, whose rows
     the kernels line carries as ``r1_apply[C=8,heads=1]`` and so on.

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
import copy
import dataclasses
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
        for attr in ("path_launches", "width_launches"):
            if hasattr(k["wrapper"], attr):
                setattr(k["wrapper"], attr, dict.fromkeys(getattr(k["wrapper"], attr), 0))


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
# the (C, heads) pairs of Restormer's published levels, and the small
# Restormer's (run/make_quality.py's restormer_tiny: dim 8, heads (1, 1, 2, 2)),
# whose bf16 runs the general forms
PUBLISHED_WIDTHS = ((48, 1), (96, 1), (96, 2), (192, 4), (384, 8))
NARROW_WIDTHS = ((8, 1), (16, 1), (32, 2), (64, 2))
# the golden chain's shapes: 4 images of 64x64 and their 32x32 level
GOLDEN_HW = ((64, 64), (32, 32))
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
        for c, heads in PUBLISHED_WIDTHS:
            for hw in RESTORMER_RAGGED:
                compare_restormer(hw + (c,), heads, dtype, gen)
        for shape, heads in RESTORMER_LEVELS:
            e = compare_restormer(shape, heads, dtype, gen)
            if dtype == torch.bfloat16 and shape == RESTORMER_LEVELS[0][0]:
                errs["r1_apply"], errs["r2_apply"] = e
    # their tap-folded forms, the same cases
    for dtype in (torch.float32, torch.bfloat16):
        for c, heads in PUBLISHED_WIDTHS:
            for hw in RESTORMER_RAGGED:
                compare_restormer(hw + (c,), heads, dtype, gen, mxu=True)
        for shape, heads in RESTORMER_LEVELS:
            e = compare_restormer(shape, heads, dtype, gen, mxu=True)
            if dtype == torch.bfloat16 and shape == RESTORMER_LEVELS[0][0]:
                errs["r1_mxu_apply"], errs["r2_mxu_apply"] = e
    # and in bf16 at shapes ragged against their bf16 forms' tiles; these
    # draw from generators of their own (numpy's, and torch's for the
    # blocks), so every other check's inputs are as they were
    forms = {f"{c}/{heads}": rb.design(1, c, heads, mxu=True) for c, heads in PUBLISHED_WIDTHS}
    print(f"  mxu forms bfloat16 (C/heads): {forms}")
    mgen = np.random.default_rng(2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        for c, heads in PUBLISHED_WIDTHS:
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
    # R1/R2 at the small Restormer's widths (fault 3.8): ragged shapes, both
    # forms, then the golden chain's shapes, float32 and bf16; from
    # generators of their own, so every check above keeps its inputs
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        errs.update(narrow_kernels(np.random.default_rng(3)))
    return errs


def narrow_name(kernel: str, c: int, heads: int) -> str:
    """The kernels line's entry of ``kernel`` at a narrow width."""
    return f"{kernel}[C={c},heads={heads}]"


def narrow_kernels(gen) -> dict:
    """R1/R2 (and R1-mxu/R2-mxu) at each narrow (C, heads) against their
    plain versions: at ragged shapes and at (4, 64, 64, C) and (4, 32, 32,
    C), in float32 and bf16, with the RestormerBlock tolerances. Returns
    each width's max|d| at (4, 64, 64, C) in float32 (the chain's dtype)."""
    forms = {f"{c}/{heads}": rb.design(1, c, heads) for c, heads in NARROW_WIDTHS}
    print(f"  narrow widths, forms bfloat16: {forms}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for c, heads in NARROW_WIDTHS:
            for hw in RESTORMER_RAGGED:
                compare_restormer(hw + (c,), heads, dtype, gen)
                compare_restormer(hw + (c,), heads, dtype, gen, mxu=True)
            for hw in GOLDEN_HW:
                e = compare_restormer((4,) + hw + (c,), heads, dtype, gen)
                if dtype == torch.float32 and hw == GOLDEN_HW[0]:
                    errs[narrow_name("r1_apply", c, heads)] = e[0]
                    errs[narrow_name("r2_apply", c, heads)] = e[1]
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
    # autograd runs the backward on its own thread, outside the range: its
    # device time is what the other ranges leave of the step's
    backward = device_ms - sum(v for k, v in split.items() if k.startswith("train_step.")
                               and k != "train_step.backward")
    row = {"ms_per_step": dt * 1e3, "train_mp_per_s": b * h * w / 1e6 / dt,
           "peak_gib": peak / 2**30, "device_ms": device_ms, "ranges_device_ms": split,
           "backward_device_ms": backward, "nafblock_kernels_device_ms": naf}
    print(f"  {name}: {dt * 1e3:.3f} ms a step (host clock over {TRAIN_STEPS} synchronised "
          f"steps), {row['train_mp_per_s']:.3f} train MP/s, peak {peak / 2**30:.2f} GiB; "
          f"profiled step: device {device_ms:.3f} ms, ranges {split}, backward {backward:.3f} ms, "
          f"K1/K2 {naf}; {smi}")
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
    plain_ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRAIN_SHAPES:
            c = shape[-1]
            p = block_params(c, dtype, gen)
            x = rand(gen, shape, -1, 1, dtype)
            compare("k1_apply", (x, p), {})
            with torch.inference_mode():
                g = nafblock.k1_plain(x, p)
            compare("k2_apply", (x, g, g.mean(dim=(1, 2), keepdim=True), p), {})
            # the plain versions' device time at the training shapes (PERF.md
            # §6's nafblock_fused row), by CUDA events over 5 calls
            with torch.inference_mode():
                m = g.mean(dim=(1, 2), keepdim=True)
                key = f"{str(dtype)[6:]} {shape}"
                plain_ms[key] = {"k1_plain": cuda_ms(lambda: nafblock.k1_plain(x, p), 5),
                                 "k2_plain": cuda_ms(lambda: nafblock.k2_plain(x, g, m, p), 5)}
            print(f"  plain versions at {key}: K1 {plain_ms[key]['k1_plain']:.3f} ms, "
                  f"K2 {plain_ms[key]['k2_plain']:.3f} ms")
            del p, x, g, m
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
              "warmup": TRAIN_WARMUP, "k1_k2_plain_ms": plain_ms}
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


RAIN13K_CONFIG = Path(__file__).resolve().parent / "configs" / "restormer_rain13k.py"
ZERO_DCE_V_CONFIG = Path(__file__).resolve().parent / "configs" / "zero_dce_v.py"
RESTORMER_PARAMS = 26_126_644   # restormer at the published width (dim 48)
# the config's first and last progressive stages (configs/restormer_rain13k.py:8-10)
RESTORMER_TRAIN_SHAPES = ((8, 128, 128, 3), (1, 384, 384, 3))
RESTORMER_VAL_HW = 128           # the first stage's crop, the CLI run's validation pairs
# a 128x128 forward fuses levels 0-2 (128, 64, 32); the latent's 8 blocks run
# at 16x16, under restormer_fast_apply's fused_min_hw of 32, as the module's
RESTORMER_FUSED_128 = RESTORMER_BLOCKS - 8
INSTANCE_CURVES = 15             # zero_dce_v's per-iteration curves at (B, 256, 256, 1)
# a fit on the card against the CPU's fit of the same image and weights, by
# steps: fit_loss and the enhanced image's max|d| over max(1, |ref|) at 1 and 3
# steps, as every card-vs-CPU check. The 100-step fit is not the same from
# run to run on the card: under torch's deterministic mode the one op left
# without a deterministic form is the bicubic resize's backward (atomics),
# and two fits still differ (``instance_determinism``). Adam moves every
# weight by about lr a step whatever its gradient's size, so two fits part a
# little more each step, most at a few pixels. The fit is held on fit_loss
# and the enhanced image's mean |d|, which stay near the CPU's: measured on
# an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §6) up to 4.7e-3 and 2.7e-3
# against the CPU, 1.3e-3 and 2.0e-3 between two card fits; a fit of 70
# steps reads 4.6e-2 and 2.6e-2, one at lr x 2 0.52 and 0.14. Held to 1.5e-2
# and 1e-2, and each planted fault must read above one of them.
TOL_INSTANCE = {1: {"fit_loss": TOL_MODEL_F32, "enhanced": TOL_MODEL_F32},
                3: {"fit_loss": TOL_MODEL_F32, "enhanced": TOL_MODEL_F32},
                100: {"fit_loss": 1.5e-2, "enhanced_mean": 1e-2}}
INSTANCE_REPEATS = 3   # card fits of 100 steps held against the one CPU fit


def rain_batch(gen, shape) -> dict:
    """Clean images and rainy ones (clean plus up to 0.3), on the card."""
    ref = gen.uniform(0, 1, shape).astype(np.float32)
    rain = np.clip(ref + gen.uniform(0, 0.3, shape), 0, 1).astype(np.float32)
    return {"image": torch.from_numpy(rain).cuda(), "ref_image": torch.from_numpy(ref).cuda()}


def restormer_step_vs_cpu(cfg: dict, gen):
    """One float32 train step of restormer at the published width on 1x64x64
    with the config's AdamW and cyclic schedule, remat and EMA 0.999 (TF32
    off), on the card and on the CPU from the same weights (temperature and
    LayerNorms drawn): the loss, every gradient and the EMA shadow after
    the step within 1e-4 x max(1, max|ref|) per tensor; no R1/R2 launch in
    the step (the module trains). Returns the card's trainer and state."""
    from enhax_torch.train import Trainer
    cpu = build_model("restormer", device="cpu", seed=10, **cfg["model_cfg"])
    draw_restormer(cpu.module, gen)
    if cpu.param_count() != RESTORMER_PARAMS:
        fail(f"restormer has {cpu.param_count()} params, expected {RESTORMER_PARAMS}")
    gpu = build_model("restormer", device="cpu", seed=10, **cfg["model_cfg"])
    gpu.module.load_state_dict(cpu.module.state_dict())
    gpu.to("cuda")
    batch = {k: v.cpu() for k, v in rain_batch(gen, (1, 64, 64, 3)).items()}
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        tr = Trainer(model, cfg["optimizer_cfg"], remat=True, ema_decay=0.999)
        state = tr.init_state()
        reset_counts()
        loss = tr._train_step(state, {k: v.to(dev) for k, v in batch.items()})["loss"].item()
        c = {k: counts()[k] for k in RST}
        grads = {k: p.grad.detach().cpu() for k, p in state.module.named_parameters()}
        ema = {k: v.detach().cpu() for k, v in state.ema.state_dict().items()}
        res[dev] = (loss, grads, ema, c)
    (loss_ref, g_ref, e_ref, _), (loss, grads, ema, c) = res["cpu"], res["cuda"]
    loss_gap = abs(loss - loss_ref) / max(1.0, abs(loss_ref))
    gap = grad_gap(grads, g_ref)
    ema_gap = grad_gap(ema, e_ref)
    print(f"  restormer train step (1x64x64, f32, remat, EMA) on the card vs the CPU: loss "
          f"{loss:.6f} / {loss_ref:.6f} (gap {loss_gap:.3e}), gradients max|d|/max(1, max|ref|) "
          f"{gap:.3e}, EMA shadow {ema_gap:.3e} (tol {TOL_MODEL_F32}); R1/R2 in the step {c}")
    if not (loss_gap <= TOL_MODEL_F32 and gap <= TOL_MODEL_F32 and ema_gap <= TOL_MODEL_F32):
        fail("the restormer train step on the card disagrees with the CPU step")
    if any(c.values()):
        fail(f"the restormer train step launched R1/R2: {c}")
    del cpu, res
    return gpu, tr, state, {"loss": loss_gap, "grad": gap, "ema": ema_gap}


def restormer_eval_after_steps(model, tr, state, gen) -> tuple:
    """Three train steps, each followed by the eval step on the EMA shadow at
    1x128x128: R1 = R2 = 36 launches an eval forward, and the shadow's R1/R2
    weights prepared anew once after each step (``update_ema`` bumps every
    shadow parameter's version: 2 makes a fused block), none on a second
    eval without a step; then the fused forward of the shadow against its
    module forward (the eager blocks) within 1e-4 x max(1, max|ref|), and
    its mean |d| within 1e-4 x max(1, mean|ref|), f32.
    Returns the launches counted and the gap."""
    from enhax_torch.kernels import _launch
    from enhax_torch.train import make_eval_step
    val = rain_batch(gen, (1, RESTORMER_VAL_HW, RESTORMER_VAL_HW, 3))
    eval_step = make_eval_step(model)
    launches = dict.fromkeys(RST, 0)
    made = []
    for i in range(3):
        if i:
            tr._train_step(state, rain_batch(gen, (1, 64, 64, 3)))
        for _ in range(1 if i else 2):   # after the first step, a second eval too
            before = _launch.prepared.makes
            reset_counts()
            eval_step(state.ema, val)
            torch.cuda.synchronize()
            c = counts()
            made.append(_launch.prepared.makes - before)
            if any(c[k] != RESTORMER_FUSED_128 for k in RST):
                fail(f"an eval forward at 128x128 launched R1/R2 {c}, expected "
                     f"{RESTORMER_FUSED_128} each")
            for k in RST:
                launches[k] += c[k]
    want = [2 * RESTORMER_FUSED_128, 0, 2 * RESTORMER_FUSED_128, 2 * RESTORMER_FUSED_128]
    with torch.inference_mode():
        fused = dataclasses.replace(model, module=state.ema).apply(val)["enhanced"]
        plain = state.ema(val["image"])["enhanced"]
    d = (fused - plain).abs()
    err, mean_err = d.max().item(), d.mean().item()
    tol = TOL_MODEL_F32 * max(1.0, plain.abs().max().item())
    # the drawn weights take the output far from [0, 1]: mean |d| is held
    # against mean |ref| as well, so that a sizeable error at most pixels shows
    mean_ref = plain.abs().mean().item()
    mean_tol = TOL_MODEL_F32 * max(1.0, mean_ref)
    print(f"  eval step after each of 3 steps: R1/R2 {RESTORMER_FUSED_128} each an eval forward; "
          f"prepared weights made {made} (expected {want}); the shadow's fused forward vs its "
          f"module forward after 3 steps max|d|={err:.3e} (tol {tol:.3e}), mean|d|="
          f"{mean_err:.3e} at mean|ref| {mean_ref:.3e} (tol {mean_tol:.3e})")
    if made != want:
        fail(f"the EMA shadow's R1/R2 weights were prepared {made} times, expected {want}")
    if not (err <= tol and mean_err <= mean_tol and torch.isfinite(fused).all()):
        fail("the eval step's fused forward of the EMA shadow disagrees with its module forward")
    return launches, err


def restormer_cli_run(gen) -> dict:
    """The train CLI on a copy of configs/restormer_rain13k.py, its
    progressive milestones cut from epochs (0, 92, 156, 204, 240) to (0, 1,
    2, 3, 4), for 3 epochs over 16 generated 256x256 train pairs and 2
    128x128 test pairs: the batches of each epoch at the schedule's crop and
    batch size (128 x 8, 160 x 5, 192 x 4; drop_last: 2, 3 and 4 steps),
    R1 = R2 = 36 in each validation (one batch of the two pairs), ``last``
    and ``best`` checkpoints, a finite val/psnr each epoch. Counts are
    reset just before the run and read just after."""
    import csv
    import tempfile
    from enhax_torch.cli import train as train_cli
    from enhax_torch.train import trainer as trainer_mod
    shapes, val_counts = [], []
    make_train, make_eval = trainer_mod.make_train_step, trainer_mod.make_eval_step

    def recording_train(*args, **kwargs):
        step = make_train(*args, **kwargs)

        def run(state, batch):
            shapes.append(tuple(batch["image"].shape))
            return step(state, batch)
        return run

    def recording_eval(*args, **kwargs):
        step = make_eval(*args, **kwargs)

        def run(module, batch):
            before = counts()
            out = step(module, batch)
            val_counts.append({k: counts()[k] - before[k] for k in RST})
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_pair_tree(root / "data", "rain13k", gen, 16, 0, 256)
        write_pair_tree(root / "data", "rain13k", gen, 0, 2, RESTORMER_VAL_HW)
        (root / "rain13k_cut.py").write_text(
            f"exec(open({str(RAIN13K_CONFIG)!r}).read())\n"
            "progressive = dict(progressive, milestones=(0, 1, 2, 3, 4))\n")
        trainer_mod.make_train_step, trainer_mod.make_eval_step = recording_train, recording_eval
        t0 = time.perf_counter()
        reset_counts()
        try:
            state = train_cli.main(["--config", str(root / "rain13k_cut.py"), "--root",
                                    str(root / "data"), "--save-dir", str(root / "run"),
                                    "--epochs", "3"])
        finally:
            trainer_mod.make_train_step, trainer_mod.make_eval_step = make_train, make_eval
        torch.cuda.synchronize()
        c = counts()
        rows = list(csv.DictReader(open(root / "run" / "log.csv")))
        ckpts = [(root / "run" / "ckpt" / n / "state.pt").is_file() for n in ("last", "best")]
    want = [(8, 128, 128, 3)] * 2 + [(5, 160, 160, 3)] * 3 + [(4, 192, 192, 3)] * 4
    print(f"  train CLI restormer_rain13k.py (milestones cut to epochs 0-4) --epochs 3: "
          f"{time.perf_counter() - t0:.1f} s, ended at step {state.step}; batches {shapes}; "
          f"R1/R2 by validation {val_counts}; launches {c}; val/psnr "
          f"{[round(float(r['val/psnr']), 4) for r in rows]}")
    if shapes != want or state.step != len(want):
        fail(f"the Restormer train CLI's batches {shapes}, expected {want}")
    if val_counts != [dict.fromkeys(RST, RESTORMER_FUSED_128)] * 3:
        fail(f"a validation launched R1/R2 {val_counts}")
    if not all(ckpts) or len(rows) != 3 or not all(np.isfinite(float(r["val/psnr"]))
                                                   for r in rows):
        fail(f"the Restormer train CLI wrote checkpoints {ckpts} and log {rows}")
    return {k: c[k] for k in RST}


def phase_train_restormer(gen, smi: str) -> dict:
    """Restormer-Rain13k training on the card (configs/restormer_rain13k.py:
    the published width, AdamW, the cyclic restart schedule, remat, EMA
    0.999): the step against the CPU, the eval step after three steps
    (R1/R2 and their prepared weights), the train CLI with progressive
    patches, and the step timed at the config's first and last stages,
    8x128x128 and 1x384x384, float32 (torch's default TF32 flags) and
    bf16-mixed, as the NAFNet rows. Returns the R1/R2 launches counted and
    the timing rows."""
    from enhax_torch.utils.config import load_config
    t_phase = time.perf_counter()
    print("[train] restormer (configs/restormer_rain13k.py) at the published width")
    cfg = load_config(RAIN13K_CONFIG)
    model, tr, state, gaps = restormer_step_vs_cpu(cfg, gen)
    launches, eval_gap = restormer_eval_after_steps(model, tr, state, gen)
    del model, tr, state
    torch.cuda.empty_cache()
    for k, n in restormer_cli_run(gen).items():
        launches[k] += n
    timing = {"card": smi, "remat": True, "ema_decay": 0.999, "cudnn_allow_tf32": True,
              "matmul_allow_tf32": False, "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP,
              "vs_cpu": gaps, "eval_vs_module": eval_gap,
              "eval_launches_128": {k: RESTORMER_FUSED_128 for k in RST}}
    with default_tf32():
        for shape in RESTORMER_TRAIN_SHAPES:
            for precision in (None, "bf16-mixed"):
                name = f"restormer_{precision or 'float32'}_{shape[0]}x{shape[1]}"
                gc.collect()
                timing[name] = time_train_step(
                    name, build_model("restormer", seed=10, **cfg["model_cfg"]),
                    rain_batch(gen, shape), cfg["optimizer_cfg"], precision, False, smi,
                    remat=True, ema_decay=0.999)
                torch.cuda.empty_cache()
    timing["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase: {timing['phase_s']:.1f} s")
    return {"launches": launches, "timing": timing}


def instance_gap(out: dict, ref: dict) -> dict:
    """|d| of fit_loss and max|d| of the enhanced image, each over max(1,
    |ref|); and the enhanced image's mean |d|, for the record."""
    loss, loss_ref = float(out["fit_loss"]), float(ref["fit_loss"])
    e, e_ref = out["enhanced"].float().cpu(), ref["enhanced"].float().cpu()
    return {"fit_loss": abs(loss - loss_ref) / max(1.0, abs(loss_ref)),
            "enhanced": (e - e_ref).abs().max().item() / max(1.0, e_ref.abs().max().item()),
            "enhanced_mean": (e - e_ref).abs().mean().item()}


def instance_start_vs_cpu(cpu, x: np.ndarray, launches: dict) -> dict:
    """At the Predictor's weights, before any fit step: the clean forward on
    the card (through fused_curve_apply) against the CPU's (enhanced and V
    fixed), and the first fit step's gradients, each within 1e-4 x max(1,
    max|ref|); the weights whose first gradient has the other sign on the
    card are counted (Adam moves each by 2 lr the other way)."""
    gpu = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module).cuda())
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        batch = {"image": torch.from_numpy(x[None]).to(dev)}
        reset_counts()
        with torch.inference_mode():
            out = model.apply(batch)
        launches[DCE[1]] += counts()[DCE[1]]
        fit = dataclasses.replace(model, module=copy.deepcopy(model.module))
        fit.forward_loss(batch)[0].backward()
        res[dev] = ({k: out[k].float().cpu() for k in ("enhanced", "image_v_fixed")},
                    {k: p.grad.cpu() for k, p in fit.module.named_parameters()})
    (out_ref, g_ref), (out, g) = res["cpu"], res["cuda"]
    gap = {"forward": grad_gap(out, out_ref), "grad": grad_gap(g, g_ref)}
    flips = sum(int(((g[k].sign() != t.sign()) & (t != 0)).sum()) for k, t in g_ref.items())
    n = sum(t.numel() for t in g_ref.values())
    print(f"  before the fit, card vs CPU: clean forward (enhanced, V fixed) max|d|/max(1, "
          f"max|ref|) {gap['forward']:.3e}, first step's gradients {gap['grad']:.3e} (tol "
          f"{TOL_MODEL_F32}); {flips} of {n} weights' first gradients of the other sign")
    if not (gap["forward"] <= TOL_MODEL_F32 and gap["grad"] <= TOL_MODEL_F32):
        fail("zero_dce_v's forward or first gradients on the card disagree with the CPU's")
    return {**gap, "sign_flips": flips, "weights": n}


def instance_fits(cpu, x: np.ndarray, launches: dict) -> dict:
    """Fits of 1, 3 and the model's 100 steps on the card (the 100-step fit
    INSTANCE_REPEATS times) against the CPU's fit of the same image and
    weights; the 100-step repeats against each other; and two planted
    faults (lr x 2, 70 steps) against the CPU's 100-step fit. Everything is
    printed before it is held: each fit within TOL_INSTANCE, each fault
    above one of the 100-step bounds."""
    gaps, outs, ref = {}, {}, None
    for steps in (1, 3, cpu.instance_steps):
        ref = Predictor(dataclasses.replace(cpu, instance_steps=steps), device="cpu")(
            {"image": x})
        pred = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module),
                                             instance_steps=steps), device="cuda")
        gaps[steps], outs[steps] = [], []
        for _ in range(INSTANCE_REPEATS if steps == cpu.instance_steps else 1):
            reset_counts()
            out = pred({"image": x})
            launches[DCE[1]] += counts()[DCE[1]]
            outs[steps].append(out)
            gaps[steps].append(instance_gap(out, ref))
            print(f"  {steps}-step fit on the card vs the CPU: fit_loss "
                  f"{float(out['fit_loss']):.6f} / {float(ref['fit_loss']):.6f}, gaps "
                  f"{gaps[steps][-1]} (tol {TOL_INSTANCE[steps]})")
    last = outs[cpu.instance_steps]
    spread_ = [instance_gap(o, last[0]) for o in last[1:]]
    print(f"  the card's 100-step fits against its first: {spread_}")
    faults = {}
    for name, kw in (("lr x 2", {"instance_lr": 2 * cpu.instance_lr}),
                     ("70 steps", {"instance_steps": 70})):
        pred = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module), **kw),
                         device="cuda")
        reset_counts()
        out = pred({"image": x})
        launches[DCE[1]] += counts()[DCE[1]]
        faults[name] = instance_gap(out, ref)
        print(f"  planted fault, {name}: fit_loss {float(out['fit_loss']):.6f}, gaps against "
              f"the CPU's 100-step fit {faults[name]}")
    for steps, rows in gaps.items():
        for gap, out in zip(rows, outs[steps]):
            tol = TOL_INSTANCE[steps]
            if not (all(gap[k] <= tol[k] for k in tol)
                    and torch.isfinite(out["enhanced"]).all()):
                fail(f"zero_dce_v's {steps}-step fit on the card disagrees with the CPU's")
    tol = TOL_INSTANCE[cpu.instance_steps]
    for name, gap in faults.items():
        if not any(gap[k] > tol[k] for k in tol):
            fail(f"the 100-step bound {tol} does not catch a fit with {name}")
    return {"vs_cpu": gaps, "card_spread": spread_, "faults": faults}


def instance_determinism(cpu, x: np.ndarray, launches: dict) -> dict:
    """Two 100-step fits on the card under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
    cuDNN's deterministic algorithms: the ops that warn they have no
    deterministic form, and the two fits' gap to each other (the default
    mode's repeats are ``instance_fits``'s). A diagnosis, not a check."""
    import warnings
    pred = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module)), device="cuda")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    outs = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            for _ in range(2):
                reset_counts()
                outs.append(pred({"image": x}))
                launches[DCE[1]] += counts()[DCE[1]]
        finally:
            torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]
    ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                  for w in caught if "deterministic" in str(w.message)})
    gap = instance_gap(outs[1], outs[0])
    print(f"  deterministic mode: ops without a deterministic form {ops}; its two 100-step "
          f"fits against each other {gap}")
    return {"ops": ops, "gap": gap}


def phase_instance(gen, smi: str) -> dict:
    """The instance path: zero_dce_v (configs/zero_dce_v.py: 32 channels, 15
    curves, down size 256) through ``Predictor`` on the card at the config's
    512x512: the clean forward and the first fit step's gradients against
    the CPU's (``instance_start_vs_cpu``); fits against the CPU's with
    planted faults (``instance_fits``); the 100-step fit's spread under
    torch's deterministic mode (``instance_determinism``); then one request
    of 100 steps timed on the host clock (torch's default TF32 flags; a
    first request before it), with one fused_curve_apply launch a request
    (the clean forward at (1, 256, 256, 1) with 15 curves) and the curve
    loop in each of the fit's 100 steps; the kernel against its plain
    version at that shape (<= 1e-5), its time there by CUDA events (the
    wrapper's host path included) and by the profiler (the kernel alone)
    beside its byte bound. Returns the launches counted, the timing row and
    the kernel's max|d|."""
    from enhax_torch.kernels.dce_curve import fused_curve_apply, fused_curve_apply_plain
    from enhax_torch.models.llie.zero_dce import ZeroDCE
    from enhax_torch.utils.config import load_config
    t_phase = time.perf_counter()
    cfg = load_config(ZERO_DCE_V_CONFIG)
    hw = cfg["image_size"]
    print(f"[instance] zero_dce_v (configs/zero_dce_v.py) through Predictor at {hw}x{hw}")
    cpu = build_model("zero_dce_v", device="cpu", seed=cfg["seed"], **cfg["model_cfg"])
    x = gen.uniform(0, 0.3, (hw, hw, 3)).astype(np.float32)
    launches = dict.fromkeys(DCE, 0)
    start = instance_start_vs_cpu(cpu, x, launches)
    fits = instance_fits(cpu, x, launches)
    fits["vs_cpu"][0] = start
    fits["deterministic"] = instance_determinism(cpu, x, launches)
    gpu = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module))
    pred = Predictor(gpu, device="cuda")
    times = []
    with default_tf32():
        for _ in range(2):
            reset_counts()
            loops = ZeroDCE.curve_loop_forwards
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred({"image": x})
            times.append(time.perf_counter() - t0)
            c, loops = counts(), ZeroDCE.curve_loop_forwards - loops
            launches[DCE[1]] += c[DCE[1]]
            if c != {**dict.fromkeys(c, 0), DCE[1]: 1} or loops != gpu.instance_steps:
                fail(f"a zero_dce_v request launched {c} with {loops} curve-loop forwards; "
                     f"expected one fused_curve_apply and {gpu.instance_steps}")
        averages, table, device_ms = profiled(lambda: pred({"image": x}), "instance_zero_dce_v")
    check_out(out, (1, hw, hw, 3))
    ops = sum(e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
    print(f"  request of {gpu.instance_steps} fit steps: {times[0] * 1e3:.1f} ms (the first), "
          f"{times[1] * 1e3:.1f} ms (the second; Predictor's own {out['time'] * 1e3:.1f} ms); "
          f"fit_loss {float(out['fit_loss']):.6f}; one fused_curve_apply, the loop in every "
          f"fit step; profiled request: device {device_ms:.3f} ms, {ops} kernel launches; "
          f"{smi}")
    print("\n".join(table.splitlines()[:16]))
    # the kernel at the instance path's shape, float32
    v = rand(gen, (1, 256, 256, 1), 0, 0.3, torch.float32)
    r = rand(gen, (1, 256, 256, INSTANCE_CURVES), -1, 1, torch.float32)
    kw = {"num_iters": INSTANCE_CURVES, "shared": False}
    err = compare(DCE[1], (v, r), kw)
    with torch.inference_mode():
        b_ms, b_by = bound(nbytes_of(v, r, v), v.numel() * 3 * INSTANCE_CURVES)
        p1 = cuda_ms(lambda: fused_curve_apply_plain(v, r, **kw), iters=20)
        k1 = cuda_ms(lambda: fused_curve_apply(v, r, **kw), iters=200)
        k2 = cuda_ms(lambda: fused_curve_apply(v, r, **kw), iters=200)
        p2 = cuda_ms(lambda: fused_curve_apply_plain(v, r, **kw), iters=20)
        n = 50
        _, _, dev_ms = profiled(lambda: [fused_curve_apply(v, r, **kw) for _ in range(n)],
                                "fused_curve_apply_instance")
    kernel = {"shape": [1, 256, 256, 1], "curves": INSTANCE_CURVES, "dtype": "float32",
              "ms": (k1 + k2) / 2, "device_ms": dev_ms / n, "plain_ms": (p1 + p2) / 2,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    print(f"  fused_curve_apply (1,256,256,1) x {INSTANCE_CURVES} curves f32: CUDA events "
          f"over 200 calls {k1:.4f} / {k2:.4f} ms a call; the kernel's own device time "
          f"(profiler, {n} calls) {dev_ms / n:.5f} ms; plain {p1:.4f} / {p2:.4f} ms; bound "
          f"{b_ms:.5f} ms by {b_by}")
    timing = {"card": smi, "hw": hw, "steps": gpu.instance_steps, "cudnn_allow_tf32": True,
              "request_ms": [t * 1e3 for t in times], "predictor_ms": out["time"] * 1e3,
              "profiled_device_ms": device_ms, "kernel_launches": ops,
              **fits, "kernel": kernel, "phase_s": time.perf_counter() - t_phase}
    print(f"  phase: {timing['phase_s']:.1f} s")
    return {"launches": launches, "timing": timing, "errs": {DCE[1]: err}}


# -- the rest of the instance models (slice 13) -----------------------------------------
CONFIGS = Path(__file__).resolve().parent / "configs"
# (name, config under configs/ or None for the registry's defaults, request H = W, depth)
INSTANCE_MODELS = (("colie_re", "colie_re.py", 512, False),
                   ("zero_mie_ms", "zero_mie_ms_lol_v1.py", 512, True),
                   ("gcenet_instance", "gcenet_instance.py", 512, True),
                   ("rrdnet_re", "rrdnet_re.py", 512, False),
                   ("zsn2n", None, 512, False),
                   ("zid", None, 128, False))
INSTANCE_PROFILE_STEPS = 10


def smooth_image(gen, hw: int, channels: int, lo: float, hi: float, noise: float = 0.0):
    """A photo-like (1, hw, hw, C) draw in [lo, hi]: uniform at hw / 16,
    bicubic up, plus Gaussian noise of ``noise``; float32 numpy."""
    base = torch.from_numpy(gen.uniform(0, 1, (1, channels, hw // 16, hw // 16)).astype(
        np.float32))
    up = torch.nn.functional.interpolate(base, size=(hw, hw), mode="bicubic",
                                         align_corners=False).clamp(0, 1)
    x = lo + (hi - lo) * up.permute(0, 2, 3, 1).numpy()
    if noise:
        x = x + gen.normal(0, noise, x.shape)
    return np.clip(x, 0, 1).astype(np.float32)


def instance_request(name: str, gen, hw: int, depth: bool) -> dict:
    """The datapoint a user of ``name`` sends: a low-light photo (a hazy
    one for zid, a noisy one for zsn2n), with a depth map where the model
    takes one."""
    if name == "zid":
        dp = {"image": smooth_image(gen, hw, 3, 0.45, 0.95)}
    elif name == "zsn2n":
        dp = {"image": smooth_image(gen, hw, 3, 0.1, 0.9, noise=0.1)}
    else:
        dp = {"image": smooth_image(gen, hw, 3, 0.02, 0.3)}
    if depth:
        dp["depth"] = smooth_image(gen, hw, 1, 0.1, 0.9)
    return dp


def instance_model(name: str, config: str | None):
    """The CPU model at the configuration the repo ships, and its seed."""
    from enhax_torch.utils.config import load_config
    if config is None:
        return build_model(name, device="cpu", seed=0), 0
    cfg = load_config(CONFIGS / config)
    return build_model(name, device="cpu", seed=cfg["seed"], **cfg["model_cfg"]), cfg["seed"]


def tensor_outputs(out: dict) -> dict:
    return {k: v.detach().float().cpu() for k, v in out.items()
            if isinstance(v, torch.Tensor) and v.ndim > 0}


def instance_model_vs_cpu(cpu, dp: dict) -> dict:
    """At the model's weights on the card against the CPU, float32, TF32
    off: every output of the clean forward; the first fit step's loss and
    every gradient; a 3-step fit's fit_loss and enhanced image, each max|d|
    over max(1, max|ref|); and the fitted state, every parameter with the
    state the JAX package's fit adds to the weights (ZID's BatchNorm
    statistics, Zero-MIE-MS's Fourier matrix B): each tensor's mean|d| over
    max(1, mean|ref|) (``gaps``, all held to TOL_MODEL_F32). An element
    whose gradient is within float32 noise of 0 (ZID's VAE decoder has
    gradients down to 1e-14) is moved by about +-lr a step by Adam whatever
    its sign, so two fits may part there by up to 2 x 3 x lr: the state's
    max|d| is held to that (``state_max``), and the elements beyond
    TOL_MODEL_F32 are counted."""
    from enhax_torch.infer.engine import fit_instance
    gpu = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module).cuda())
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in dp.items()}
        with torch.inference_mode():
            out = tensor_outputs(model.apply(batch))
        step = dataclasses.replace(model, module=copy.deepcopy(model.module))
        loss, _ = step.forward_loss(batch)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                 for k, p in step.module.named_parameters()}
        fit, fit_loss = fit_instance(model, batch, 3, model.instance_lr,
                                     model.instance_weight_decay)
        with torch.inference_mode():
            enhanced = fit.apply(batch)["enhanced"].float().cpu()
        state = {k: p.detach().cpu() for k, p in fit.module.named_parameters()}
        res[dev] = (out, float(loss), grads, float(fit_loss), enhanced, state)
    (out_r, loss_r, g_r, fl_r, e_r, st_r), (out, loss, g, fl, e, st) = res["cpu"], res["cuda"]
    start = dict(cpu.module.named_parameters())
    moved = sorted(k for k in st_r if not torch.equal(st_r[k], start[k].detach()))
    extra = [k for k in st_r if k.endswith((".mean", ".var")) or k == "B"]
    gap = {"forward": grad_gap(out, out_r),
           "loss": abs(loss - loss_r) / max(1.0, abs(loss_r)),
           "grad": grad_gap(g, g_r),
           "fit_loss": abs(fl - fl_r) / max(1.0, abs(fl_r)),
           "enhanced": grad_gap({"e": e}, {"e": e_r}),
           "state_mean": max((st[k] - st_r[k]).abs().mean().item()
                             / max(1.0, st_r[k].abs().mean().item()) for k in st_r)}
    return {"gaps": gap, "state_max": grad_gap(st, st_r),
            "stats_B_max": grad_gap({k: st[k] for k in extra}, {k: st_r[k] for k in extra})
            if extra else None,
            "beyond_tol": sum(int(((st[k] - st_r[k]).abs() > TOL_MODEL_F32).sum()) for k in st_r),
            "state_n": sum(t.numel() for t in st_r.values()), "start_loss": loss,
            "fit3_loss": fl, "params": len(st_r), "params_moved": len(moved),
            "extra": len(extra), "extra_moved": sum(k in moved for k in extra)}


def phase_instance_models(gen, smi: str) -> dict:
    """The rest of the instance models through ``Predictor`` on the card,
    one of each family at its published width and the configuration the
    repo ships (``INSTANCE_MODELS``): for each, ``instance_model_vs_cpu``
    (within TOL_MODEL_F32); one full request of the model's
    ``instance_steps`` on the host clock, synchronised, with torch's default
    TF32 flags (the second of two where a request takes under 10 s, else
    the first), its peak memory, fit_loss (finite, below the start loss) and
    output range, with every kernel count 0 (no kernel of the port lies on
    these models' path); and a profiled request of
    ``INSTANCE_PROFILE_STEPS`` steps (device time and kernel launches a
    step, the clean forward included). Everything is printed before it is
    held."""
    t_phase = time.perf_counter()
    rows, failures = {}, []
    for name, config, hw, depth in INSTANCE_MODELS:
        t_model = time.perf_counter()
        cpu, seed = instance_model(name, config)
        dp = instance_request(name, gen, hw, depth)
        print(f"[instance models] {name} ({config or 'registry defaults'}, seed {seed}; "
              f"{cpu.param_count():,} params) at {hw}x{hw}"
              f"{' with depth' if depth else ''}, {cpu.instance_steps} steps")
        vs = instance_model_vs_cpu(cpu, dp)
        adam_reach = 2 * 3 * cpu.instance_lr
        stats = ("" if vs["stats_B_max"] is None else
                 f", of the BatchNorm statistics and B {vs['stats_B_max']:.3e}"
                 f" ({vs['extra_moved']} of {vs['extra']} moved)")
        print(f"  card vs CPU (f32, TF32 off): {vs['gaps']} (tol {TOL_MODEL_F32}); fitted "
              f"state max|d| {vs['state_max']:.3e} (tol {adam_reach:.1e}){stats}, "
              f"{vs['beyond_tol']} of {vs['state_n']} elements beyond {TOL_MODEL_F32}; "
              f"start loss {vs['start_loss']:.6f}, 3-step fit_loss {vs['fit3_loss']:.6f}; "
              f"{vs['params_moved']} of {vs['params']} parameters moved in 3 steps")
        if not (all(v <= TOL_MODEL_F32 for v in vs["gaps"].values())
                and vs["state_max"] <= adam_reach):
            failures.append(f"{name}: the card disagrees with the CPU {vs['gaps']}, "
                            f"state max|d| {vs['state_max']}")
        pred = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module)),
                         device="cuda")
        times, launched = [], []
        with default_tf32():
            for _ in range(2):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pred(dp)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                launched.append(sum(counts().values()))
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                if times[0] >= 10.0:
                    break
            prof = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module),
                                                 instance_steps=INSTANCE_PROFILE_STEPS),
                             device="cuda")
            prof(dp)    # a warm-up
            averages, table, device_ms = profiled(lambda: prof(dp), f"instance_{name}")
        ops = sum(e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
        y = out["enhanced"]
        fit_loss = float(out["fit_loss"])
        request_s = times[-1]
        row = {"config": config, "seed": seed, "hw": hw, "depth": depth,
               "params": cpu.param_count(), "steps": cpu.instance_steps,
               "lr": cpu.instance_lr, "weight_decay": cpu.instance_weight_decay,
               "vs_cpu": vs["gaps"], "state_max": vs["state_max"],
               "stats_B_max": vs["stats_B_max"], "state_beyond_tol": vs["beyond_tol"],
               "params_moved_3_steps": vs["params_moved"],
               "request_s": times, "timed": "second" if len(times) == 2 else "first",
               "predictor_s": out["time"], "ms_a_step": request_s * 1e3 / cpu.instance_steps,
               "peak_gib": peak, "start_loss": vs["start_loss"], "fit_loss": fit_loss,
               "out_min": float(y.min()), "out_max": float(y.max()),
               "kernel_launches": launched,
               "profiled_steps": INSTANCE_PROFILE_STEPS,
               "profiled_device_ms": device_ms,
               "device_ms_a_step": device_ms / INSTANCE_PROFILE_STEPS,
               "launches_a_step": ops / INSTANCE_PROFILE_STEPS,
               "model_s": time.perf_counter() - t_model, "card": smi}
        rows[name] = row
        print(f"  request of {cpu.instance_steps} steps: {' / '.join(f'{t:.3f}' for t in times)} s "
              f"(timed the {row['timed']}; Predictor's own {out['time']:.3f} s), "
              f"{row['ms_a_step']:.2f} ms a step; peak {peak:.3f} GiB; fit_loss {fit_loss:.6f} "
              f"(start {vs['start_loss']:.6f}); output in [{row['out_min']:.4f}, "
              f"{row['out_max']:.4f}]; kernel launches {launched}; profiled request of "
              f"{INSTANCE_PROFILE_STEPS} steps: device {device_ms:.3f} ms, {ops} launches "
              f"({row['launches_a_step']:.0f} a step); {smi}")
        print("\n".join(table.splitlines()[:12]))
        if not (torch.isfinite(y).all() and np.isfinite(fit_loss)
                and fit_loss < vs["start_loss"]):
            failures.append(f"{name}: fit_loss {fit_loss} not finite or not below the start "
                            f"loss {vs['start_loss']}, or the output not finite")
        if tuple(y.shape) != (1, hw, hw, 3):
            failures.append(f"{name}: output {tuple(y.shape)}")
        if any(launched):
            failures.append(f"{name}: a request launched a kernel of the port {launched}")
        del pred, prof, out
        torch.cuda.empty_cache()
    print(f"  phase: {time.perf_counter() - t_phase:.1f} s")
    if failures:
        fail("; ".join(failures))
    return {"models": rows, "phase_s": time.perf_counter() - t_phase}


# -- the quality chains (QUALITY.json's nine rows) --------------------------------

QUALITY_RECORD = Path(__file__).resolve().parent / "QUALITY.json"
# tests/test_quality_artifact.py's bars: the trained chains and the video
# beat the input by 5 dB, the rest by 0.3 dB; SSIM above the input's less
# 0.05 (uformer_tiny above 0.46); GT-mean PSNR no lower than PSNR less 0.2;
# the tiled chain within -2.5 dB of the untiled one
QUALITY_TRAINED = ("zero_dce_re", "hinet_tiny", "nafnet_tiny", "restormer_tiny",
                   "uformer_tiny", "video_chain")
QUALITY_SSIM_FLOOR = {"uformer_tiny": 0.46}
# the card's row against the CPU's on the same weights (the artifact's own
# tolerances), and after QUALITY_SHORT epochs from the same init
QUALITY_TOL_PSNR, QUALITY_TOL_SSIM = 0.5, 0.02
QUALITY_SHORT, QUALITY_SHORT_TOL_PSNR, QUALITY_SHORT_TOL_SSIM = 3, 1e-2, 1e-3
# two bars that the JAX package's own chain does not keep when its init is
# multiplied by 1 + 1e-7 or so: a row that misses one is held instead at the
# mean less 3 standard deviations of that chain's readings from its init
# times 1 + offset (tools/quality_spread.py --package jax, key 0, over 21
# offsets 0, +-1e-7 ... +-1e-6, on one XLA thread: SSIM 0.4491 +- 0.032,
# gap -2.1945 +- 0.2535 dB)
QUALITY_JAX_FLOOR = {("uformer_tiny", "ssim"): 0.3531,
                     ("hinet_tiny_tiled", "delta_vs_untiled"): -2.9549}


def quality_bars(name: str, row: dict) -> tuple[list, list]:
    """The bars of tests/test_quality_artifact.py a row misses: (held, kept
    at ``QUALITY_JAX_FLOOR``). A bar of ``QUALITY_JAX_FLOOR`` that the row
    misses is held at the JAX chain's floor there; missed there too, it is
    held."""
    held, spread = [], []

    def bar(key: str, ok: bool, msg: str) -> None:
        floor = QUALITY_JAX_FLOOR.get((name, key))
        if ok:
            return
        if floor is not None and row[key] >= floor:
            spread.append(f"{msg}; above the JAX chain's mean - 3 sd, {floor}")
        else:
            held.append(msg)

    gain = 5.0 if name in QUALITY_TRAINED else 0.3
    bar("psnr", row["psnr"] > row["input_psnr"] + gain,
        f"psnr {row['psnr']} <= input {row['input_psnr']} + {gain}")
    floor = QUALITY_SSIM_FLOOR.get(name, row["input_ssim"] - 0.05)
    bar("ssim", row["ssim"] > floor, f"ssim {row['ssim']} <= {floor}")
    if "psnr_gt_mean" in row:
        bar("psnr_gt_mean", row["psnr_gt_mean"] >= row["psnr"] - 0.2,
            f"psnr_gt_mean {row['psnr_gt_mean']} < psnr - 0.2")
    if name == "hinet_tiny_tiled":
        bar("delta_vs_untiled", row["delta_vs_untiled"] >= -2.5,
            f"delta_vs_untiled {row['delta_vs_untiled']} < -2.5")
    if name == "video_chain":
        bar("frames", row["frames"] == 8, f"{row['frames']} frames")
    return held, spread


def quality_launches(name: str, c: dict, widths: dict) -> None:
    """The kernels each chain's predict must launch on the card: the curve
    kernel once an image in zero_dce_re's, K1 = K2 = the fused blocks (C <=
    64) an image in nafnet_tiny's, R1 = R2 > 0 at (8, 1) and (16, 1) in
    restormer_tiny's (its blocks at 64x64 and 32x32)."""
    from enhax_torch import quality as q
    cfg = {row[0]: row[2] for row in q.MODELS_UNDER_TEST}
    if name == "zero_dce_re" and c["fused_curve_apply"] != 4:
        fail(f"zero_dce_re's predict launched fused_curve_apply {c['fused_curve_apply']} "
             "times, not once an image")
    if name == "nafnet_tiny":
        from enhax_torch.constants import MODELS
        from enhax_torch.models.multitask.nafnet import NAFBlock
        with torch.device("meta"):   # the structure only
            m = MODELS.build("nafnet", **cfg["nafnet_tiny"])
        fused = sum(b.conv1.in_channels <= 64 for b in m.module.modules()
                    if isinstance(b, NAFBlock))
        if not c["k1_apply"] == c["k2_apply"] == 4 * fused:
            fail(f"nafnet_tiny's predict: K1 {c['k1_apply']}, K2 {c['k2_apply']}, expected "
                 f"{4 * fused} each")
    if name == "restormer_tiny":
        r1, r2 = widths["r1_apply"], widths["r2_apply"]
        if not (c["r1_apply"] == c["r2_apply"] > 0 and r1 == r2
                and r1[(8, 1)] > 0 and r1[(16, 1)] > 0):
            fail(f"restormer_tiny's predict: R1 {c['r1_apply']} {r1}, R2 {c['r2_apply']} {r2}")


def width_counts() -> dict:
    return {k: dict(KERNELS[k]["wrapper"].width_launches) for k in RST}


def cpu_rows_on_card_weights(q, root: Path) -> dict:
    """The trained chains' predict and metric on the CPU from the card's
    checkpoints, and the tiled and video chains from its hinet_tiny's."""
    from enhax_torch.cli.predict import predict
    rows = {}
    for name, model, cfg, *_ in q.MODELS_UNDER_TEST:
        out = predict({"model": model, "model_cfg": cfg, "data": str(q.GOLDEN / "image"),
                       "weights": str(root / name / "ckpt" / "last"),
                       "save_dir": str(root / f"{name}_cpu" / "pred"), "device": "cpu"})
        rows[name] = q.chain_scores(out, q.GOLDEN / "ref", "cpu")
    rows["hinet_tiny_tiled"] = q.run_chain("hinet_tiny_tiled_cpu",
                                           dict(q.EXTRA_CHAINS)["hinet_tiny_tiled"], root, "cpu")
    rows["video_chain"] = q.run_video_chain("video_chain_cpu", root, "cpu")
    return rows


def short_chains(q, root: Path) -> dict:
    """The five trained chains for QUALITY_SHORT epochs from the same init on
    the card and on the CPU: {name: (card row, cpu row)}."""
    out = {}
    for name, model, cfg, sup, _, lr in q.MODELS_UNDER_TEST:
        out[name] = tuple(q.run_one(name, model, cfg, sup, QUALITY_SHORT, lr, root / device,
                                    device) for device in ("cuda", "cpu"))
    return out


def phase_quality(smi: str) -> dict:
    """The nine quality chains (``enhax_torch.quality``: from the JAX
    package's init, train on the golden set -> the predict CLI -> the
    metric CLI) on the card, float32 with TF32 off and torch's
    deterministic algorithms. Held:

      * the card's rows to tests/test_quality_artifact.py's bars, two of
        them at the JAX chain's mean less 3 standard deviations where the row
        misses them (``QUALITY_JAX_FLOOR``);
      * the card against the CPU within 0.5 dB and 0.02 SSIM (the
        artifact's tolerances): the trained chains' predict and metric on
        the CPU from the card's checkpoints, the tiled and video chains from
        its hinet_tiny's, the two instance chains (fits from the same init)
        run on the CPU after the card's;
      * the card's training against the CPU's: the five trained chains for
        QUALITY_SHORT epochs from the same init on each device, within 0.01
        dB and 0.001 SSIM. Over the full 60 and 120 epochs the two devices'
        trajectories part (float32 sums in another order, amplified by Adam
        as the JAX package's own are by a 1e-7 change of its init,
        tools/quality_spread.py), so they are held over 3.

    The predict runs' launches: the curve kernel, K1/K2 and R1/R2 as
    ``quality_launches`` asks. Then restormer_tiny at 4x256x256 through
    ``Predictor``, whose 64x64 and 32x32 levels run (32, 2) and (64, 2),
    against the CPU. Returns the rows, the launches and R1/R2's by width."""
    import tempfile
    from enhax_torch import quality as q
    print("[quality] the nine chains on the card, then against the CPU")
    record = json.loads(QUALITY_RECORD.read_text())["results"]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_quality_")
    root = Path(tmp.name)
    launches = dict.fromkeys(KERNELS, 0)
    widths = {k: dict.fromkeys(rb.KERNEL_WIDTHS, 0) for k in RST}
    rows = {}
    t0 = time.perf_counter()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        chains = [(row[0], lambda row=row: q.run_one(*row, root / "card", "cuda"))
                  for row in q.MODELS_UNDER_TEST]
        chains += [(name, lambda name=name, spec=spec: q.run_chain(name, spec, root / "card",
                                                                   "cuda"))
                   for name, spec in q.EXTRA_CHAINS]
        chains.append(("video_chain", lambda: q.run_video_chain("video_chain", root / "card",
                                                                "cuda")))
        for name, run in chains:
            t1 = time.perf_counter()
            reset_counts()
            rows[name] = run()
            c, w = counts(), width_counts()
            quality_launches(name, c, w)
            for k in KERNELS:
                launches[k] += c[k]
            for k in RST:
                for width, n in w[k].items():
                    widths[k][width] += n
            print(f"  card {name} ({time.perf_counter() - t1:.1f} s): {rows[name]}; launches "
                  f"{ {k: v for k, v in c.items() if v} }")
        rows["hinet_tiny_tiled"]["delta_vs_untiled"] = round(
            rows["hinet_tiny_tiled"]["psnr"] - rows["hinet_tiny"]["psnr"], 3)
        card_s = time.perf_counter() - t0
        reset_counts()
        same_weights = cpu_rows_on_card_weights(q, root / "card")
        t1 = time.perf_counter()
        cpu_instance = {name: q.run_chain(name, spec, root / "cpu", "cpu")
                        for name, spec in q.EXTRA_CHAINS if not spec.get("_reuse_ckpt")}
        print(f"  the instance chains on the CPU: {time.perf_counter() - t1:.1f} s")
        short = short_chains(q, root / "short")
        c = counts()
        for k in KERNELS:
            launches[k] += c[k]
        # every narrow width on the card: a larger image reaches (32, 2), (64, 2)
        reset_counts()
        cfg = q.MODELS_UNDER_TEST[3][2]
        x = np.random.default_rng(19).uniform(0, 1, (4, 256, 256, 3)).astype(np.float32)
        out = Predictor(build_model("restormer", seed=0, **cfg)).infer({"image": x})
        c, w = counts(), width_counts()
        ref = Predictor(build_model("restormer", device="cpu", seed=0, **cfg),
                        device="cpu").infer({"image": x})["enhanced"]
        err = (out["enhanced"].cpu() - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        print(f"  restormer_tiny 4x256x256 on the card vs the CPU: max|d|={err:.3e} (tol "
              f"{TOL_MODEL_F32 * scale:.3e}); R1/R2 by width {w}")
        if not err <= TOL_MODEL_F32 * scale:
            fail("restormer_tiny at 4x256x256 on the card disagrees with the CPU")
        if not all(w[k][width] > 0 for k in RST for width in NARROW_WIDTHS):
            fail(f"restormer_tiny at 4x256x256 left a narrow width unlaunched: {w}")
        for k in KERNELS:
            launches[k] += c[k]
        for k in RST:
            for width, n in w[k].items():
                widths[k][width] += n
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        tmp.cleanup()
    print(f"  card chains {card_s:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    bad = []
    for name, row in rows.items():
        ref = same_weights.get(name) or cpu_instance[name]
        d_psnr, d_ssim = row["psnr"] - ref["psnr"], row["ssim"] - ref["ssim"]
        held, spread = quality_bars(name, row)
        if abs(d_psnr) > QUALITY_TOL_PSNR or abs(d_ssim) > QUALITY_TOL_SSIM:
            held.append(f"card vs cpu psnr {d_psnr:+.3f} ssim {d_ssim:+.4f}")
        if name in short:
            sc, sp = short[name]
            ds_psnr, ds_ssim = sc["psnr"] - sp["psnr"], sc["ssim"] - sp["ssim"]
            print(f"  {name} after {QUALITY_SHORT} epochs: card psnr {sc['psnr']} ssim "
                  f"{sc['ssim']} | cpu psnr {sp['psnr']} ssim {sp['ssim']}")
            if abs(ds_psnr) > QUALITY_SHORT_TOL_PSNR or abs(ds_ssim) > QUALITY_SHORT_TOL_SSIM:
                held.append(f"after {QUALITY_SHORT} epochs card vs cpu psnr {ds_psnr:+.3f} "
                            f"ssim {ds_ssim:+.4f}")
        rec = record[name]
        print(f"  {name}: card psnr {row['psnr']} ssim {row['ssim']} | cpu psnr {ref['psnr']} "
              f"ssim {ref['ssim']} ({'its fit' if name in cpu_instance else 'the card weights'})"
              f" | QUALITY.json psnr {rec['psnr']} ssim {rec['ssim']} (input "
              f"{row['input_psnr']} / {row['input_ssim']})" + (f" MISSED {held}" if held else "")
              + (f"; {spread}" if spread else ""))
        if held:
            bad.append((name, held))
    if bad:
        fail(f"quality chains miss their bars: {bad}")
    return {"rows": rows, "cpu_instance": cpu_instance, "cpu_on_card_weights": same_weights,
            "short": short, "launches": launches, "widths": widths, "card_s": card_s}


# -- Uformer-B ----------------------------------------------------------------------

UFORMER_PARAMS = 50_880_946      # uformer_b: dim 32, depths (1, 2, 8, 8, 2, 8, 8, 2, 1)
UFORMER_BENCH = (2, 736, 1280, 3)  # bench_all.py:153-154's camera frames (768x1280 padded)
UFORMER_TRAIN_BATCH = (16, 128, 128, 3)  # bench_train.py:203-204's restoration rows' batch


def phase_uformer(gen, smi: str) -> dict:
    """uformer_b at the published width: on the card against the CPU at
    1x128x128 (float32, TF32 off, within 1e-4 x max(1, max|ref|)); served
    through ``Predictor`` at 2x736x1280 in bf16 and float32 (TF32 off) as
    the HINet rows are timed (host clock over 3 batches after a warm-up and
    a collection, one batch under torch.profiler, peak memory); a train step
    at 16x128x128 (Charbonnier, Adam, float32 with torch's default TF32
    flags) timed from step 1 as the other train rows; the predict CLI once
    with --benchmark. No kernel of the port runs (the JAX package computes
    Uformer in XLA)."""
    import tempfile
    import cv2
    from enhax_torch.cli import predict as predict_cli
    print("[uformer] uformer_b at the published width")
    cpu = build_model("uformer_b", device="cpu", seed=4)
    if cpu.param_count() != UFORMER_PARAMS:
        fail(f"uformer_b has {cpu.param_count()} params, not {UFORMER_PARAMS}")
    card = copy.deepcopy(cpu).to(device="cuda")
    x = torch.from_numpy(gen.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_counts()
        with torch.inference_mode():
            out = card.apply({"image": x.cuda()})["enhanced"].cpu()
            ref = cpu.apply({"image": x})["enhanced"]
        if any(counts().values()):
            fail(f"uformer_b launched a kernel of the port: {counts()}")
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        print(f"  card vs CPU at 1x128x128, float32, TF32 off: max|d|={err:.3e} (tol "
              f"{TOL_MODEL_F32 * scale:.3e})")
        if not err <= TOL_MODEL_F32 * scale:
            fail("uformer_b on the card disagrees with the CPU")
        bench = {}
        outs = {}
        for dtype in (torch.bfloat16, torch.float32):
            gc.collect()
            bench[str(dtype)[6:]], outs[dtype] = bench_uformer(card, dtype)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    d = (outs[torch.bfloat16] - outs[torch.float32]).abs()
    scale = max(1.0, outs[torch.float32].abs().max().item())
    bench["bfloat16"]["vs_float32"] = {"max_abs": d.max().item(), "mean_abs": d.mean().item()}
    print(f"  bf16 vs float32 serving: max|d|={d.max().item():.4e} (tol "
          f"{TOL_HINET_BF16 * scale:.4e}), mean|d|={d.mean().item():.4e}")
    if not d.max().item() <= TOL_HINET_BF16 * scale:
        fail("uformer_b's bf16 serving disagrees with its float32 serving")
    del card, outs
    gc.collect()
    print(f"[uformer] train step {UFORMER_TRAIN_BATCH}, Charbonnier, Adam, float32")
    model = build_model("uformer_b", seed=5)
    ref = torch.from_numpy(gen.uniform(0, 1, UFORMER_TRAIN_BATCH).astype(np.float32)).cuda()
    batch = {"image": (ref + 0.1 * torch.randn(ref.shape, device="cuda",
                                               generator=torch.Generator("cuda").manual_seed(0))
                       ).clamp(0, 1), "ref_image": ref}
    with default_tf32():
        train = time_train_step("uformer_b_f32", model, batch,
                                {"optimizer": {"name": "adam", "lr": 2e-4}}, None, False, smi,
                                remat=False, ema_decay=None)
    del model, batch
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(2):
            img = (gen.uniform(0, 1, (256, 256, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(Path(tmp) / f"{i}.png"), img)
        predict_cli.main(["--model", "uformer_b", "--data", tmp, "--save-dir",
                          str(Path(tmp) / "out"), "--benchmark"])
        if len(list((Path(tmp) / "out").glob("*.png"))) != 2:
            fail("the predict CLI did not write uformer_b's two images")
    return {"bench": bench, "train": train, "vs_cpu_max_abs": err}


def bench_uformer(card, dtype) -> tuple[dict, torch.Tensor]:
    """uformer_b at 2x736x1280 through a ``Predictor`` (padded to 768x1280 by
    the divisor 128): host clock over 3 synchronised batches after a
    warm-up, peak memory, one batch under torch.profiler."""
    name = str(dtype)[6:]
    pred = Predictor(card, bf16=dtype == torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        0, 1, UFORMER_BENCH).astype(np.float32)).cuda()
    out = pred.infer({"image": x})
    check_out(out, UFORMER_BENCH, unit=False)
    first = out["enhanced"].cpu()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    n, fwd = 3, []
    t0 = time.perf_counter()
    for _ in range(n):
        fwd.append(pred.infer({"image": x})["time"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    _, table, device_ms = profiled(lambda: pred.infer({"image": x}), f"uformer_{name}")
    print("\n".join(table.splitlines()[:16] + table.splitlines()[-3:]))
    mps = UFORMER_BENCH[0] * UFORMER_BENCH[1] * UFORMER_BENCH[2] / 1e6 / dt
    print(f"  uformer_b 2x736x1280 {name}: {mps:.3f} MP/s, {dt * 1e3:.3f} ms per batch (host "
          f"clock over {n} batches; the Predictor's forward {np.mean(fwd) * 1e3:.3f} ms), peak "
          f"{peak / 2**30:.3f} GiB; device time {device_ms:.3f} ms in the profiled batch")
    return {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "forward_ms": float(np.mean(fwd)) * 1e3,
            "device_ms": device_ms, "peak_gib": peak / 2**30}, first


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


def narrow_timing(gen) -> dict:
    """R1 and R2 at each narrow width at the golden chain's (4, 64, 64, C),
    float32 as the chain serves them (the general forms; their products on
    the float32 units): kernel and plain version by CUDA events in turns
    (plain, kernel, kernel, plain), the bound as ``phase_timing`` counts it
    with the products at the float32 rate. Returns the kernels line's rows."""
    print("[timing] R1/R2 at the narrow widths, (4, 64, 64, C), float32")
    res = {}
    with torch.inference_mode():
        for c, heads in NARROW_WIDTHS:
            shape = (4, 64, 64, c)
            px, hd = 4 * 64 * 64, c // heads
            p = restormer_params(c, heads, torch.float32, gen)
            hid = p["ffn.project_out.weight"].shape[1]
            x = rand(gen, shape, -1, 1, torch.float32)
            v, gram, qss, kss = rb.r1_plain(x, p)
            attn = rb.mdta_attention(gram, qss, kss, p["attn.temperature"], torch.float32)
            r1p = {k: p[k] for k in rb.R1_KEYS}
            r2p = {k: p[k] for k in rb.R2_KEYS}
            cases = (("r1_apply", (x, p), nbytes_of(x, r1p, v, gram, qss, kss), px * 65 * c,
                      px * (6 * c * c + 2 * c * hd)),
                     ("r2_apply", (x, v, attn, p), nbytes_of(x, v, attn, r2p, x),
                      px * (9 * c + 66 * hid), px * (2 * c * hd + 2 * c * c + 6 * c * hid)))
            for name, args, nbytes, flops, mm_flops in cases:
                k = KERNELS[name]
                b_ms, b_by = bound(nbytes, flops, mm_flops)
                p1 = cuda_ms(lambda: k["plain"](*args), iters=5, warmup=1)
                k1 = cuda_ms(lambda: k["wrapper"](*args), iters=20)
                k2 = cuda_ms(lambda: k["wrapper"](*args), iters=20)
                p2 = cuda_ms(lambda: k["plain"](*args), iters=5, warmup=1)
                ms = (k1 + k2) / 2
                print(f"  {narrow_name(name, c, heads)} {shape}: kernel {k1:.4f} / {k2:.4f} ms, "
                      f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                      f"({nbytes / 1e6:.3f} MB), {b_ms / ms:.1%} of the bound")
                res[narrow_name(name, c, heads)] = {"ms": ms, "plain_ms": (p1 + p2) / 2,
                                                     "bound_ms": b_ms, "bound_by": b_by,
                                                     "library_ms": None}
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
    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        print(f"[time] {what}: {time.perf_counter() - t_start:.1f} s since the start", flush=True)

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
    elapsed("build and kernel checks")
    phase_model_vs_cpu(gen)
    launches = {**phase_serve(gen), **phase_serve_nafnet(gen), **phase_serve_restormer(gen)}
    with torch.random.fork_rng():
        phase_serve_hinet(np.random.default_rng(13))
    # the train phases draw from generators of their own and leave torch's
    # untouched, so the later phases check and time what they did before them
    with torch.random.fork_rng(devices=[]):
        elapsed("serving")
        train = phase_train(np.random.default_rng(10), smi)
        train_more = phase_train_hinet_zero_dce(np.random.default_rng(11), smi)
        train_rst = phase_train_restormer(np.random.default_rng(16), smi)
        elapsed("training")
        instance = phase_instance(np.random.default_rng(17), smi)
        instance_models = phase_instance_models(np.random.default_rng(18), smi)
        elapsed("instance models")
        gc.collect()
        uformer = phase_uformer(np.random.default_rng(20), smi)
    for k in NAF:
        launches[k] += train["launches"][k]
    for k in DCE:
        launches[k] += train_more["launches"][k] + instance["launches"][k]
    for k in RST:
        launches[k] += train_rst["launches"][k]
    errs[DCE[1]] = max(errs[DCE[1]], train_more["errs"][DCE[1]], instance["errs"][DCE[1]])
    train["timing"]["hinet_zero_dce"] = train_more["timing"]
    train["timing"]["restormer"] = train_rst["timing"]
    elapsed("uformer")
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
    elapsed("probes and bench")
    timing = phase_timing(gen, probes)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(21)
        timing.update(narrow_timing(np.random.default_rng(21)))
    elapsed("kernel timing")
    # last, after every timed phase: its chains run with torch's deterministic
    # algorithms, and its CPU chains would take cores from a timed phase
    with torch.random.fork_rng(devices=[]):
        quality = phase_quality(smi)
    elapsed("quality chains")
    for k in KERNELS:
        launches[k] += quality["launches"][k]
    kernels = []
    for name, k in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[name],
                        "max_abs_err": errs[name], **timing[name]})
    # R1/R2 at the small Restormer's widths: the quality chains' launches
    for name in RST:
        for c, heads in NARROW_WIDTHS:
            entry = narrow_name(name, c, heads)
            kernels.append({"name": entry, "route": "cuda", "source": KERNELS[name]["source"],
                            "replaces": KERNELS[name]["replaces"],
                            "launches": quality["widths"][name][(c, heads)],
                            "max_abs_err": errs[entry], **timing[entry]})
    print(json.dumps({"probes": probes}))
    print(json.dumps({"bench": bench}))
    print(json.dumps({"train": train["timing"]}))
    print(json.dumps({"instance": instance["timing"]}))
    print(json.dumps({"instance_models": instance_models}))
    print(json.dumps({"quality": {k: quality[k] for k in ("rows", "cpu_instance", "cpu_on_card_weights",
                                                          "short", "card_s")}}))
    print(json.dumps({"uformer": uformer}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
