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
     misaligned base); the apply kernel likewise on both its paths
     (``apply_path``): "vec" with a shared curve (273 values, one pixel,
     C = 4, several chunks, SGZ's 4x1092x1920) and with per-iteration
     curves at C = 3 and 8 iterations (one pixel, 15, 256 and 3922 pixels,
     Zero-DCE's 1x1088x1920 with 24 curves), each also against the
     "general" path on the same inputs; "general" at C = 1 with 15 curves,
     at C = 3 with 1, 7 and 16 iterations and with the image or the curves
     2 elements off 16-byte alignment; at the main shapes in float32 with images U(0, 1), both
     paths no further from float64 than the plain version
     (``apply_witness``). The NAFBlock kernels K1 and K2 and the
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
     apply kernel once on its "vec" path; every NAFNet forward launches K1 and K2 8 times each;
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
     of 100 steps timed (one fused_curve_apply a request on its "general"
     path, none in the fit),
     and the kernel at (1, 256, 256, 1) with 15 curves against its plain
     version and timed, with the host's time a call of the wrapper, of its
     launch and of ``apply_path`` (an ``{"instance": ...}`` line); then
     (``phase_instance_models``) colie_re, zero_mie_ms, gcenet_instance,
     rrdnet_re, zsn2n and zid through ``Predictor`` at their shipped
     configurations (512x512; zid 128x128; a generated depth map for
     zero_mie_ms and gcenet_instance): each on the card against the CPU
     (f32, TF32 off: the clean forward, the first step's loss and
     gradients, a 3-step fit's loss and output, within 1e-4 x max(1,
     max|ref|); the fitted state with ZID's BatchNorm statistics and the
     Fourier matrix, each tensor's mean|d| within 1e-4 x max(1, mean|ref|)
     and every element within Adam's reach, 2 x 3 x lr), one full request
     of its instance_steps (zid's cut to 100 of its 500, rrdnet_re's to 100
     of 1000, zsn2n's to 300 of 3000) timed with its peak memory, fit_loss
     and output range (no kernel launched),
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
     fitted on the CPU in processes of their own, CoLIE's four images
     apart, started before the build and waited for before phase 2) and
     after 3 epochs of
     training from the same init within 0.01 dB and 0.001 SSIM; the curve
     kernel (on its "vec" path), K1/K2 and R1/R2 at (8, 1) and (16, 1) launch in the chains'
     predicts, (32, 2) and (64, 2) in a 4x256x256 restormer_tiny request (a
     ``{"quality": ...}`` line);
  5e. Uformer-B (``phase_uformer``): ``uformer_b`` on the card against the
     CPU at 1x128x128 (float32, TF32 off, 1e-4 x max(1, max|ref|)), served at
     2x736x1280 in bf16 and float32 and a 16x128x128 train step, timed as
     the HINet rows, and the predict CLI once with --benchmark (a
     ``{"uformer": ...}`` line);
  5f. the low-light and retouch families (``phase_llie_families``, no
     kernel of the port): ``hvi_cidnet_re`` at its published width on the
     card against the CPU at 1x128x128, served at 2x736x1280 in bf16 and
     float32 (bf16's mean |d| from float32 within 3e-2, its max within 0.3,
     x max(1, max|ref|)) and its
     config's train step timed at 1x256x256; ``lyt_net_re`` served at
     2x736x1280 in float32 (its attention over 15,360 pooled tokens); one
     shipped config of each family (``configs/gcenet_ulol.py`` without
     depth, zero_ig_re, psenet, hvi_cidnet_re, lyt_net_re, llunet++_re,
     lllinet, neurop_re, neurop_init): the first train step's loss and
     gradients against the CPU's on one image at the config's crop, at
     most 128x128 (1e-4 x max(1, max|ref|) in float32; hvi_cidnet_re,
     zero_ig_re, lllinet and neurop_init in float64 on both devices, and
     the card's float32 against the CPU's float64, the loss within 1e-4 and
     the gradients within 4x the CPU's own float32 gap), 3 steps timed at
     the config's batch and crop, and one 512x512 request through
     ``Predictor`` (zero_ig_re through the instance route, 250 of its 1000
     fit steps, timed only) (an ``{"llie_families": ...}`` line);
  5g. the small zero-reference low-light models (``phase_llie_zero_ref``):
     zero_didce, sgz, sci, ruas, pairlie and rsfnet: the first train step
     on the card against the CPU's on the same weights and one 128x128
     image (``family_check``, float32, TF32 off, 1e-4 x max(1, max|ref|);
     sci and rsfnet in FAMILY_FLOAT64, float64 on both devices), 3 Adam
     steps at 8x256x256 (no kernel launched in a step); one 512x512
     request of each of the eight names through ``Predictor`` (rsfnet
     fitting 100 of its 500 steps, timed only; lime as DUAL with the host's
     direct solve; sgz launches ``fused_curve_apply`` once a request, on
     its "vec" path, in every request, batch and predict CLI image below,
     the others none);
     ``fused_curve_apply`` in its shared form against its plain version at
     SGZ's shapes (4x1092x1920 and 1x528x396, float32 and bf16, the DCE
     tolerances); sgz at its published width through ``Predictor``: on the
     card against the CPU at 2x264x480 and a 517x389 request (padded to
     528x396), then 4x1088x1920 in bf16 and float32 (host clock, peak
     memory, a profiled batch, one curve-kernel launch a request, bf16
     within 1e-2 x max(1, max|ref|) of float32); the predict CLI over two
     PNGs for sgz and lime; the kernel timed at SGZ's bench shape in bf16
     and float32 by ``apply_turns``, with ``torch.add`` of the same bytes
     beside it (an ``{"llie_zero_ref": ...}`` line);
  5h. Zero-Restore (``zero_restore_checks`` after phase 4, while the CPU's
     instance chains finish; ``phase_zero_restore``): zero_restore_llie,
     _dehaze and _uie at the configs' width (64 channels): the clean
     forward and the first fit step's loss, and in float64 also the first
     step's gradients and a 3-step fit's fit_loss, output and state, on
     the card against the CPU at 1x128x128 (slice 13's rule, TF32 off); one
     timed 512x512 request through
     ``Predictor`` of 100 of its 1000 / 10000 fit steps
     (``INSTANCE_REQUEST_STEPS``; fit_loss finite and below the image's
     start loss, no kernel of the port launched); a profiled request of
     10 steps (device ms and launches a step, the idle share); the
     predict CLI with ``--config configs/zero_restore_llie.py`` on one
     512x512 PNG, its fit cut to 20 steps (``cut_fit`` wraps the
     ``build_model`` the CLI calls) (a ``{"zero_restore": ...}`` line);
  5i. the metric CLI (``phase_metric_cli``) on the card over four 512x512
     result / target pairs: every extended full-reference metric, NIQE
     with params fitted on the card and with an official-layout ``.npz``
     written from them, BRISQUE with a synthetic libsvm ``.npz`` and
     without, ``--task segment`` on 19-class label maps; each run's
     seconds, each mean held to the same run with ``--device cpu``
     (``METRIC_TOL``) (a ``{"metric_cli": ...}`` line). A ``[clock]`` line
     prints the seconds these two phases added beside those the instance
     models' one timed request (no longer two) saved;
  5j. the last multitask models (``phase_multitask``, no kernel of the
     port): mprnet, airnet (its DCNv2 gathers) and adair at their published
     widths on the card against the CPU on one 64x64 pair, float32 with
     TF32 off (AdaIR also with fre_n 8, its frequency boxes compared
     between the devices first): every served output, the train step's
     outputs and loss, every gradient and AirNet's updated running
     statistics within 1e-4 x max(1, max|ref|) (the CPU's side computed in
     a process of its own, started before phase 2); each served at
     2x736x1280 through ``Predictor`` in bf16 and float32 (TF32 off; ms a
     batch, MP/s, peak memory, a bf16 batch profiled without the host's op
     events; bf16's mean|d| from float32 within 0.3 x max(1, max|ref|), and at
     1x64x64 within 4x the CPU's own bf16 gap on the same input) and
     trained 3 Adam steps at batch 4 of its papers' crop (MPRNet 256^2,
     AirNet and AdaIR 128^2; AirNet on its batch's statistics) (a
     ``{"multitask": ...}`` line);
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
     shape in bf16 and at (4, 1088, 1920, 3) in float32; the apply kernel
     (the kernels line's time through the wrapper, as every row's) also
     beside its first design under both of ``apply_turns``' methods and
     its host time a call, at Zero-DCE's 1x1088x1920 with 24 curves in
     bf16 and float32 (``{"apply_turns": ...}`` lines); K1 and K2 at
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
import zlib
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


def ap_paths() -> dict:
    return dict(dce_curve.fused_curve_apply.path_launches)


def want_apply_paths(label: str, path: str, n: int) -> None:
    """Fail unless ``fused_curve_apply`` launched ``n`` times on ``path``
    and on no other since the counts were reset."""
    paths = ap_paths()
    if paths != {p: n * (p == path) for p in paths}:
        fail(f"{label}: fused_curve_apply paths {paths}, expected {n} on {path!r}")


def counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x.float() * 255.0).round().clamp(0, 255).to(torch.uint8)


def rand(gen: np.random.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    a = gen.uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def dce_gap(out: torch.Tensor, ref: torch.Tensor) -> tuple[bool, str]:
    """The DCE kernels' tolerance: max|d| <= TOL_F32 in float32, at most
    TOL_BF16_LSB uint8 levels in bfloat16; and a line saying so."""
    if not torch.isfinite(out.float()).all():
        return False, "non-finite output"
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.float32:
        return err <= TOL_F32, f"max|d|={err:.3e} (tol {TOL_F32})"
    lsb = (to_u8(out).int() - to_u8(ref).int()).abs().max().item()
    return lsb <= TOL_BF16_LSB, f"max|d|={err:.3e}, {lsb} uint8 LSB (tol {TOL_BF16_LSB})"


def compare(name: str, args: tuple, kwargs: dict) -> float:
    """Run the kernel and its plain version on the same card inputs; return
    max|d| in float32 and check it against the dtype's tolerance."""
    k = KERNELS[name]
    before = up_paths(), ap_paths()
    with torch.inference_mode():
        out = k["wrapper"](*args, **kwargs)
        ref = k["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    if name in DCE:
        if name == DCE[0]:
            path = dce_curve.upsample_path(args[0].shape, args[0].dtype, kwargs["scale"],
                                           args[0].data_ptr())
        else:
            path = dce_curve.apply_path(args[0].shape, args[0].dtype, kwargs["shared"],
                                        (args[0].data_ptr(), args[1].data_ptr(), out.data_ptr()),
                                        kwargs["num_iters"])
        took = [p for p, v in (up_paths() if name == DCE[0] else ap_paths()).items()
                if v != before[DCE.index(name)][p]]
        if took != [path]:
            fail(f"{name} at {tuple(args[0].shape)}: the path function says {path}, took {took}")
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
    else:
        ok, text = dce_gap(out, ref)
        print(f"  {name} {shape} {str(args[0].dtype)[6:]} {kwargs}: {text}")
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

# (N, H, W, C), shared, iterations of the apply kernel's checks. Shared:
# 273 values (not a multiple of 8), one pixel, C = 4, several of the "vec"
# path's chunks with a short last one; per iteration at C = 3: one pixel,
# 15 pixels, one warp's item of 256, 3922 pixels (several items, the last
# short and not a multiple of 8); then "general": 7, 16 and 1 iterations
# at C = 3, and C = 1 with 15 curves (zero_dce_v's form)
APPLY_CASES = [((1, 7, 13, 3), True, 8), ((1, 1, 1, 3), True, 8), ((3, 33, 65, 4), True, 8),
               ((2, 37, 53, 3), True, 8), ((1, 1, 1, 3), False, 8), ((1, 3, 5, 3), False, 8),
               ((1, 16, 16, 3), False, 8), ((2, 37, 53, 3), False, 8), ((2, 17, 31, 3), False, 7),
               ((1, 40, 40, 3), False, 16), ((1, 1, 5, 3), False, 1), ((2, 64, 64, 1), False, 15)]
SGZ_APPLY = (4, 1092, 1920, 3)    # SGZ's bench batch padded by 12, a shared curve
DCE_APPLY = (1, 1088, 1920, 3)    # zero_dce_re's 1080p request padded to 32, 24 curves

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
    # the apply kernel's two paths: from a generator of its own, so every
    # other check's inputs are as they were
    apply_kernel_checks(np.random.default_rng(4))
    apply_witness(np.random.default_rng(6))
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


def apply_kernel_checks(gen) -> None:
    """``fused_curve_apply`` against its plain version at APPLY_CASES and at
    SGZ's and Zero-DCE's main shapes, float32 and bf16, each on the path
    ``apply_path`` names (``compare`` fails if the wrapper took another);
    every case that takes "vec" also against the "general" path on the same
    inputs, with the same tolerance; a base 2 elements off 16-byte alignment
    (the image, or the curves) takes "general". Images are U(0, 1), at the
    main shapes U(0, 0.3) as every main-path check of this script draws
    them (low-light inputs; ``apply_witness`` holds both designs and the
    plain version to float64 at U(0, 1) there)."""
    ap = DCE[1]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, shared, iters in APPLY_CASES + [(SGZ_APPLY, True, 8), (DCE_APPLY, False, 8)]:
            rc = shape[-1] * (1 if shared else iters)
            x = rand(gen, shape, 0, 0.3 if shape in (SGZ_APPLY, DCE_APPLY) else 1, dtype)
            r = rand(gen, shape[:3] + (rc,), -1, 1, dtype)
            kw = {"num_iters": iters, "shared": shared}
            compare(ap, (x, r), kw)
            want = ("vec" if shared or (shape[-1] == 3 and iters == dce_curve.SPAN_ITERS)
                    else "general")
            ptrs = (x.data_ptr(), r.data_ptr(), x.data_ptr())
            if dce_curve.apply_path(shape, dtype, shared, ptrs, iters) != want:
                fail(f"{ap} at {shape} {kw}: apply_path does not say {want!r}")
            if want == "vec":
                with torch.inference_mode():
                    vec = dce_curve._apply_launch(x, r, iters, shared, "vec")
                    general = dce_curve._apply_launch(x, r, iters, shared, "general")
                ok, text = dce_gap(vec, general)
                print(f"  {ap} {shape} {str(dtype)[6:]} {kw}: vec vs general {text}")
                if not ok:
                    fail(f"{ap}'s two paths disagree at {shape} {kw}")
        shape = (2, 37, 53, 3)
        for shared in (True, False):
            rc = 3 if shared else 24
            for off in ("image", "curves"):
                x = rand(gen, shape, 0, 1, dtype)
                r = rand(gen, shape[:3] + (rc,), -1, 1, dtype)
                t = x if off == "image" else r
                moved = torch.empty(t.numel() + 2, device="cuda", dtype=dtype)[2:].view(t.shape)
                moved.copy_(t)
                x, r = (moved, r) if off == "image" else (x, moved)
                ptrs = (x.data_ptr(), r.data_ptr(), 0)
                if dce_curve.apply_path(shape, dtype, shared, ptrs, 8) != "general":
                    fail(f"{ap}: a misaligned {off} does not take the general path")
                compare(ap, (x, r), {"num_iters": 8, "shared": shared})


def apply_witness(gen) -> None:
    """At the main shapes in float32 with images U(0, 1): the "vec" path,
    the "general" path and the plain version against the same loop in
    float64 on the card (max|d| each). The kernels contract y + r(y^2 - y)
    into two fused multiply-adds an iteration, the plain version rounds
    four operations; the curve step's slope 1 + r(2y - 1), up to 2, can
    grow a rounding 2^8-fold over 8 iterations, so over 25M values the two
    part by about 1e-5. Fails unless each path is at least as close to
    float64 as the plain version."""
    for shape, shared in ((SGZ_APPLY, True), (DCE_APPLY, False)):
        x = rand(gen, shape, 0, 1, torch.float32)
        r = rand(gen, shape[:3] + (3 if shared else 24,), -1, 1, torch.float32)
        with torch.inference_mode():
            ref = dce_curve.apply_curves(x.double(), r.double(), 8, shared)
            outs = {"vec": dce_curve._apply_launch(x, r, 8, shared, "vec"),
                    "general": dce_curve._apply_launch(x, r, 8, shared, "general"),
                    "plain": dce_curve.fused_curve_apply_plain(x, r, 8, shared)}
            gaps = {k: (v.double() - ref).abs().max().item() for k, v in outs.items()}
            gaps["vec_vs_plain"] = (outs["vec"] - outs["plain"]).abs().max().item()
        print(f"  fused_curve_apply {shape} {'shared' if shared else '24 curves'} float32, "
              f"x ~ U(0, 1), max|d| from float64: {gaps}")
        if max(gaps["vec"], gaps["general"]) > gaps["plain"]:
            fail(f"fused_curve_apply at {shape}: a path lies further from float64 than the "
                 "plain version")
        del x, r, ref, outs


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


def profiled(fn, name: str, ops: bool = True) -> tuple:
    """Run ``fn`` once under torch.profiler and synchronise; the whole
    table (by self device time) goes to build/profiles/profile_<name>.txt.
    Returns the key averages, the table and the device time in ms: the
    device events' own time (an op's entry repeats its kernels' time, so
    the sum over all entries would count it twice). With ``ops=False`` the
    host's operator events are left out and the table lists kernels and
    CUDA runtime calls (``cudaLaunchKernel`` among them): the same device
    time and launch counts, and on a 10-step instance fit (~9,400 launches)
    ``key_averages`` took 1.9 s instead of 6.0-6.2 s (an H100 machine)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if ops:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
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
def tf32_off():
    """cuDNN's convs and matmuls in full float32 (the checks against the
    CPU). Not ``torch.backends.cudnn.flags(allow_tf32=False)``, which also
    turns cuDNN off (its ``enabled`` defaults to False)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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
              f"launches {c}, upsample paths {paths}, apply paths {ap_paths()}")
        want = {"general": 0, "vec": 1} if upsample else {"general": 0, "vec": 0}
        if paths != want or c[DCE[0]] != int(upsample) or c[DCE[1]] != int(not upsample):
            fail(f"{label}: launched {c}, upsample paths {paths}")
        want_apply_paths(label, "vec", int(not upsample))
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
    loop in each of the fit's 100 steps, and a request of
    INSTANCE_PROFILE_STEPS steps under the profiler; the kernel against its plain
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
            want_apply_paths("a zero_dce_v request", "general", 1)
        # the profile over a request of INSTANCE_PROFILE_STEPS steps, as the
        # other instance models' (a 100-step one took 23 s of the script)
        prof = Predictor(dataclasses.replace(gpu, instance_steps=INSTANCE_PROFILE_STEPS),
                         device="cuda")
        t0 = time.perf_counter()
        averages, table, device_ms = profiled(lambda: prof({"image": x}), "instance_zero_dce_v",
                                              ops=False)
        prof_s = time.perf_counter() - t0
    check_out(out, (1, hw, hw, 3))
    ops = sum(e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
    print(f"  request of {gpu.instance_steps} fit steps: {times[0] * 1e3:.1f} ms (the first), "
          f"{times[1] * 1e3:.1f} ms (the second; Predictor's own {out['time'] * 1e3:.1f} ms); "
          f"fit_loss {float(out['fit_loss']):.6f}; one fused_curve_apply, the loop in every "
          f"fit step; profiled request of {INSTANCE_PROFILE_STEPS} steps: device "
          f"{device_ms:.3f} ms, {ops} kernel launches; {smi}")
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
        # the host's time a call: the wrapper, its launch alone (a fresh
        # output) and the path choice alone, in alternating turns
        ptrs = (v.data_ptr(), r.data_ptr(), v.data_ptr())
        host = {"fused_curve_apply": lambda: fused_curve_apply(v, r, **kw),
                "launch": lambda: dce_curve._apply_launch(v, r, INSTANCE_CURVES, False,
                                                          "general"),
                "apply_path": lambda: dce_curve.apply_path(v.shape, v.dtype, False, ptrs,
                                                           INSTANCE_CURVES)}
        host_times = {k: [] for k in host}
        for rep in range(5):
            for k in (list(host) if rep % 2 == 0 else list(reversed(host))):
                host_times[k].append(host_us(host[k]))
    host_times = {k: spread(t, "us") for k, t in host_times.items()}
    kernel = {"shape": [1, 256, 256, 1], "curves": INSTANCE_CURVES, "dtype": "float32",
              "ms": (k1 + k2) / 2, "device_ms": dev_ms / n, "plain_ms": (p1 + p2) / 2,
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "host_us": host_times}
    print(f"  fused_curve_apply (1,256,256,1) x {INSTANCE_CURVES} curves f32: CUDA events "
          f"over 200 calls {k1:.4f} / {k2:.4f} ms a call; the kernel's own device time "
          f"(profiler, {n} calls) {dev_ms / n:.5f} ms; plain {p1:.4f} / {p2:.4f} ms; bound "
          f"{b_ms:.5f} ms by {b_by}; host time a call " + ", ".join(
              f"{k} {t['us']:.1f} us ({t['us_min']:.1f}-{t['us_max']:.1f})"
              for k, t in host_times.items()))
    timing = {"card": smi, "hw": hw, "steps": gpu.instance_steps, "cudnn_allow_tf32": True,
              "request_ms": [t * 1e3 for t in times], "predictor_ms": out["time"] * 1e3,
              "profiled_s": prof_s, "profiled_device_ms": device_ms, "kernel_launches": ops,
              "profiled_steps": INSTANCE_PROFILE_STEPS, **fits, "kernel": kernel,
              "phase_s": time.perf_counter() - t_phase}
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
# a timed request cut short of the model's instance_steps, for the script's
# clock: zid's 500 steps took 27-34 s a request, rrdnet_re's 1000 15-17 s,
# zsn2n's 3000 18-22 s, zero_ig_re's 1000 43.6-48.4 s and rsfnet's 500
# 17.2 s on an H100 machine (a host 60% slower took rsfnet's 250 in 13.8 s);
# a tenth to a quarter of them keep each request host-bound, every step as
# long as before
INSTANCE_REQUEST_STEPS = {"zid": 100, "rrdnet_re": 100, "zsn2n": 300, "zero_ig_re": 250,
                          "rsfnet": 100, "zero_restore_llie": 100, "zero_restore_dehaze": 100,
                          "zero_restore_uie": 100}
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
    ``instance_steps`` (``INSTANCE_REQUEST_STEPS`` where cut) on the host
    clock, synchronised, with torch's default
    TF32 flags (one request: the script once timed the second of two where
    a request took under 10 s, a repeat its clock no longer pays for), its
    peak memory, fit_loss (finite, below the start loss) and
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
        steps = INSTANCE_REQUEST_STEPS.get(name, cpu.instance_steps)
        pred = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module),
                                             instance_steps=steps), device="cuda")
        with default_tf32():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred(dp)
            torch.cuda.synchronize()
            times = [time.perf_counter() - t0]
            launched = [sum(counts().values())]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = Predictor(dataclasses.replace(cpu, module=copy.deepcopy(cpu.module),
                                                 instance_steps=INSTANCE_PROFILE_STEPS),
                             device="cuda")
            prof(dp)    # a warm-up
            t0 = time.perf_counter()
            averages, table, device_ms = profiled(lambda: prof(dp), f"instance_{name}",
                                                  ops=False)
            prof_s = time.perf_counter() - t0
        ops = sum(e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
        y = out["enhanced"]
        fit_loss = float(out["fit_loss"])
        request_s = times[-1]
        row = {"config": config, "seed": seed, "hw": hw, "depth": depth,
               "params": cpu.param_count(), "steps": steps,
               "lr": cpu.instance_lr, "weight_decay": cpu.instance_weight_decay,
               "vs_cpu": vs["gaps"], "state_max": vs["state_max"],
               "stats_B_max": vs["stats_B_max"], "state_beyond_tol": vs["beyond_tol"],
               "params_moved_3_steps": vs["params_moved"],
               "request_s": times, "timed": "first",
               "predictor_s": out["time"], "ms_a_step": request_s * 1e3 / steps,
               "peak_gib": peak, "start_loss": vs["start_loss"], "fit_loss": fit_loss,
               "out_min": float(y.min()), "out_max": float(y.max()),
               "kernel_launches": launched,
               "profiled_steps": INSTANCE_PROFILE_STEPS, "profiled_s": prof_s,
               "profiled_device_ms": device_ms,
               "device_ms_a_step": device_ms / INSTANCE_PROFILE_STEPS,
               "launches_a_step": ops / INSTANCE_PROFILE_STEPS,
               "model_s": time.perf_counter() - t_model, "card": smi}
        rows[name] = row
        print(f"  request of {steps} steps: {times[0]:.3f} s "
              f"(one request; Predictor's own {out['time']:.3f} s), "
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
    if name == "zero_dce_re":
        want_apply_paths("zero_dce_re's predict", "vec", 4)
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


# the CPU's instance chains in processes of their own, QUALITY_CPU_THREADS torch
# threads each: CoLIE's four fits (100 steps of a 256x256 SIREN each) one a
# process, Zero-MIE-MS's in one
QUALITY_CPU_PARTS = {"colie_instance": ((0,), (1,), (2,), (3,)),
                     "zero_mie_ms_instance": ((0, 1, 2, 3),)}
QUALITY_CPU_THREADS = 2


def start_cpu_instance_chains(root: Path) -> list:
    """Start the instance chains' CPU predicts (``QUALITY_CPU_PARTS``), each
    part ``python -m enhax_torch.quality --chain ... --images ...`` writing
    into ``root/<chain>/pred``. Returns [(chain, part, process, log)]."""
    root.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, parts in QUALITY_CPU_PARTS.items():
        for part in parts:
            log = open(root / f"{name}_{'_'.join(map(str, part))}.log", "w")
            cmd = [sys.executable, "-m", "enhax_torch.quality", "--chain", name, "--images",
                   ",".join(map(str, part)), "--out-root", str(root), "--device", "cpu",
                   "--threads", str(QUALITY_CPU_THREADS)]
            procs.append((name, part, subprocess.Popen(
                cmd, cwd=Path(__file__).resolve().parent, stdout=log,
                stderr=subprocess.STDOUT), log))
    return procs


def finish_cpu_instance_chains(procs: list, root: Path, timeout: float = 900) -> dict:
    """Wait for ``start_cpu_instance_chains``'s processes and score each
    chain's images on the CPU; a part that fails fails the script."""
    from enhax_torch import quality as q
    deadline = time.perf_counter() + timeout
    for name, part, proc, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            log.close()
        if rc != 0:
            print(Path(log.name).read_text()[-4000:])
            fail(f"the CPU's {name} on golden images {part} exited {rc}")
    return {name: q.chain_row(dict(q.EXTRA_CHAINS)[name], root / name / "pred", "cpu")
            for name in QUALITY_CPU_PARTS}


def stop(procs: list) -> None:
    for _, _, proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def short_chains(q, root: Path) -> dict:
    """The five trained chains for QUALITY_SHORT epochs from the same init on
    the card and on the CPU: {name: (card row, cpu row)}."""
    out = {}
    for name, model, cfg, sup, _, lr in q.MODELS_UNDER_TEST:
        out[name] = tuple(q.run_one(name, model, cfg, sup, QUALITY_SHORT, lr, root / device,
                                    device) for device in ("cuda", "cpu"))
    return out


def phase_quality(smi: str, cpu_instance: dict) -> dict:
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
        its hinet_tiny's, the two instance chains against ``cpu_instance``
        (``finish_cpu_instance_chains``: fits from the same init on the
        CPU, which ``main`` runs beside the build);
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


# -- GCENet on ulol and the low-light / retouch families (slice 15) -------------------

CIDNET_PARAMS = 1_975_569            # hvi_cidnet_re: channels (36, 36, 72, 144), heads (1, 2, 4, 8)
CIDNET_CONFIG = "hvi_cidnet_re_lol_v1.py"
# hvi_cidnet_re's bf16 serving against its float32 serving: HINet's 3e-2 x
# max(1, max|ref|) on the mean |d|, and 0.3 on the max. On random weights 13%
# of the pixels move over 3e-2 in bf16, in both packages: at 1x128x128 on the
# CPU the JAX package's own bf16 output is 1.0 (max) / 0.117 (mean) from its
# float32, the port's 0.149 / 0.0075 (tests/test_torch_hvi_cidnet.py holds the
# port's mean gap under the JAX package's); the card read 0.179 / 0.0123 at
# 2x736x1280, over a 3e-2 bound on the max
TOL_CIDNET_BF16_MEAN = 3e-2
TOL_CIDNET_BF16_MAX = 0.3
# one shipped config a family, trained at its own batch and crop: gcenet's ulol
# without depth, as ulol carries no depth maps (tests/test_torch_gcenet_train.py)
FAMILY_CONFIGS = (("gcenet_ulol.py", {"use_depth": False}), ("zero_ig_re_lol_v1.py", {}),
                  ("psenet_sice_mix.py", {}), (CIDNET_CONFIG, {}), ("lyt_net_re_lol_v1.py", {}),
                  ("llunetpp_re_lol_v1.py", {}), ("lllinet_lol_v1.py", {}),
                  ("neurop_re_fivek_e.py", {}), ("neurop_init.py", {}))
FAMILY_TRAIN_STEPS = 3
# the first step is held to the CPU's on one image at the config's crop, at
# most FAMILY_CHECK_HW (the CPU's step in-process, on the same weights and
# batch as the card's); the config's own batch and crop are timed on the card
FAMILY_CHECK_HW = 128
FAMILY_SERVE_HW = 512
# names whose loss reads no reference image
UNPAIRED = ("gcenet", "zero_ig_re", "psenet")
# families whose float32 first step parts from the CPU's by rounding further
# than TOL_MODEL_F32: hvi_cidnet_re's (on random weights its float32 gradients
# lie 0.01-1.4 x max(1, max|ref|) from float64 on the CPU itself at 1x256^2,
# the card's as far; its float32 loss within 1e-7), neurop_init's (an L1
# gradient over 512x512 x 3 pixels of nearly cancelling signs through 1x1
# convs: the card read 8.0e-4 at the config's crop), lllinet's (instance norms
# and SimAM's variances: the card read 1.35e-4 at 1x256^2); zero_ig_re's too,
# where float64 found fault 3.10. Each is held in float64 on both devices at
# TOL_MODEL_F32, and the card's float32 against the CPU's float64
# (``family_check``). So are rsfnet's (its scalar thresholds' gradients are
# sums over every pixel of nearly cancelling terms: the card read 1.16e-3 at
# 1x128^2) and sci's (9.1e-5), of the zero-reference models
FAMILY_FLOAT64 = ("hvi_cidnet_re", "zero_ig_re", "neurop_init", "lllinet", "sci", "rsfnet")
FAMILY_FACTOR = 4.0


def family_batch(name: str, b: int, hw: int, gen) -> dict:
    """A batch of the shape the config trains on: low-light images (and
    their references where the loss reads them; neurop_init's operator
    pairs and strengths)."""
    def img(lo, hi):
        return torch.from_numpy(gen.uniform(lo, hi, (b, hw, hw, 3)).astype(np.float32))

    if name == "neurop_init":
        out = {}
        for k in ("ex", "bc", "vb"):
            out[f"image_{k}"], out[f"ref_{k}"] = img(0.0, 1.0), img(0.0, 1.0)
            out[f"val_{k}"] = torch.from_numpy(gen.uniform(-1, 1, (b,)).astype(np.float32))
        return out
    ref = img(0.05, 0.95)
    out = {"image": (ref * torch.from_numpy(gen.uniform(0.1, 0.4, (b, 1, 1, 1)).astype(
        np.float32))).contiguous()}
    if name not in UNPAIRED:
        out["ref_image"] = ref
    return out


def first_step(model, batch: dict) -> tuple:
    """The loss and every parameter's gradient of one training forward."""
    model.module.zero_grad(set_to_none=True)
    loss, _ = model.forward_loss(batch)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.module.named_parameters()
             if p.grad is not None}
    model.module.zero_grad(set_to_none=True)
    return loss.item(), grads


def family_setup(config: str, over: dict, check: bool = False) -> tuple:
    """A family's config, model name and keywords, and a batch of the
    config's batch and crop (with ``check``, one image at the crop capped at
    FAMILY_CHECK_HW), drawn from a generator seeded by the config's name."""
    from enhax_torch.utils.config import load_config
    cfg = load_config(CONFIGS / config)
    name, mcfg = cfg["model"], {**cfg.get("model_cfg", {}), **over}
    b, hw = cfg["data_cfg"]["batch_size"], cfg["image_size"]
    if check:
        b, hw = 1, min(hw, FAMILY_CHECK_HW)
    batch = family_batch(name, b, hw, np.random.default_rng(zlib.crc32(config.encode())))
    return cfg, name, mcfg, batch


def step_gaps(step: tuple, ref: tuple) -> dict:
    """The loss's and each gradient's max|d| / max(1, max|ref|), by name."""
    (loss, grads), (ref_loss, ref_grads) = step, ref
    if set(grads) != set(ref_grads):
        fail(f"gradients of {sorted(set(grads) ^ set(ref_grads))} on one device only")
    gaps = {k: (grads[k] - g).abs().max().item() / max(1.0, g.abs().max().item())
            for k, g in ref_grads.items()}
    return {"loss": abs(loss - ref_loss) / max(1.0, abs(ref_loss)), **gaps}


def family_check(name: str, mcfg: dict, seed: int, batch: dict) -> tuple:
    """A family's first step on the card against the CPU's, from ``seed``
    on ``batch`` (TF32 as the caller sets it): the loss and every gradient
    within TOL_MODEL_F32 x max(1, max|ref|) in float32; for
    ``FAMILY_FLOAT64`` in float64 on both devices at TOL_MODEL_F32, and the
    card's float32 against the CPU's float64: the loss at TOL_MODEL_F32,
    the gradients within FAMILY_FACTOR x the CPU's own float32 gradients'
    gap from it (at least TOL_MODEL_F32). Returns (gaps, bounds, (card
    loss, CPU loss) in float32)."""
    f32, f64 = torch.float32, torch.float64
    steps = {}
    for device in ("cpu", "cuda"):
        for dtype in (f32, f64) if name in FAMILY_FLOAT64 else (f32,):
            model = build_model(name, device=device, seed=seed, dtype=dtype, **mcfg)
            steps[device, dtype] = first_step(
                model, {k: v.to(device, dtype) for k, v in batch.items()})
            del model
    torch.cuda.empty_cache()
    if name in FAMILY_FLOAT64:
        ref = steps["cpu", f64]
        own = step_gaps(steps["cpu", f32], ref)
        card32 = step_gaps(steps["cuda", f32], ref)
        gaps = {"float64": max(step_gaps(steps["cuda", f64], ref).values()),
                "float32_loss": card32.pop("loss"), "float32_grads": max(card32.values()),
                "cpu_float32_grads": max(v for k, v in own.items() if k != "loss")}
        bounds = {"float64": TOL_MODEL_F32, "float32_loss": TOL_MODEL_F32,
                  "float32_grads": max(TOL_MODEL_F32, FAMILY_FACTOR * gaps["cpu_float32_grads"])}
    else:
        gaps = {"float32": max(step_gaps(steps["cuda", f32], steps["cpu", f32]).values())}
        bounds = {"float32": TOL_MODEL_F32}
    return gaps, bounds, (steps["cuda", f32][0], steps["cpu", f32][0])


def families_vs_cpu() -> dict:
    """``family_check`` of each family's shipped config, from the config's
    seed on ``family_setup``'s check batch, TF32 off."""
    rows = {}
    for config, over in FAMILY_CONFIGS:
        cfg, name, mcfg, batch = family_setup(config, over, check=True)
        t0 = time.perf_counter()
        gaps, bounds, (loss, ref_loss) = family_check(name, mcfg, cfg["seed"], batch)
        hw = batch[next(iter(batch))].shape[1]
        print(f"  {config}: {name} 1x{hw}x{hw}, first step card vs CPU: loss {loss:.6f} / "
              f"{ref_loss:.6f}, gaps {gaps} (bounds {bounds}); both devices "
              f"{time.perf_counter() - t0:.1f} s")
        if not all(gaps[k] <= bounds[k] for k in bounds):
            fail(f"{config}: the card's first train step disagrees with the CPU's: {gaps}")
        rows[config] = {**gaps, "bounds": bounds, "hw": hw, "s": time.perf_counter() - t0}
    return rows


def family_steps(config: str, over: dict, gen, smi: str) -> dict:
    """FAMILY_TRAIN_STEPS steps of the config's optimizer on the card in
    float32 at the config's batch and crop (host clock, synchronised; the
    losses finite, peak memory), then one served request."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import Trainer
    cfg, name, mcfg, batch = family_setup(config, over)
    card = build_model(name, seed=cfg["seed"], **mcfg)
    dev = {k: v.cuda() for k, v in batch.items()}
    tr = Trainer(card, build_optimizer(cfg.get("optimizer_cfg") or {}))
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    with default_tf32():
        for _ in range(FAMILY_TRAIN_STEPS):
            t1 = time.perf_counter()
            losses.append(tr._train_step(state, dev)["loss"].item())
            times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        fail(f"{config}: a train step's loss is not finite: {losses}")
    b, hw = batch[next(iter(batch))].shape[:2]
    print(f"  {config}: {name} {b}x{hw}x{hw}, {FAMILY_TRAIN_STEPS} steps on the card: losses "
          f"{losses}, {' / '.join(f'{t * 1e3:.1f}' for t in times)} ms (host clock, "
          f"synchronised, the first with cuDNN's search), peak {peak:.2f} GiB; {smi}")
    row = {"model": name, "batch": [b, hw, hw], "losses": losses,
           "step_ms": [t * 1e3 for t in times], "peak_gib": peak}
    if name != "neurop_init":   # the operators' pretraining serves no image
        row["serve"] = family_serve(card, gen)
    del card, state, tr, dev
    gc.collect()
    torch.cuda.empty_cache()
    return row


def family_serve(model, gen) -> dict:
    """One request at FAMILY_SERVE_HW^2 through ``Predictor`` (an instance
    model fits its ``instance_steps`` first, INSTANCE_REQUEST_STEPS where
    cut), host clock."""
    x = smooth_image(gen, FAMILY_SERVE_HW, 3, 0.02, 0.3)
    n = INSTANCE_REQUEST_STEPS.get(model.name, model.instance_steps)
    out = Predictor(dataclasses.replace(model, instance_steps=n)).infer({"image": x})
    check_out(out, x.shape, unit=False)
    steps = (f" ({n} of its {model.instance_steps} fit steps, {out['time'] * 1e3 / n:.2f} ms a "
             f"step, fit_loss {float(out['fit_loss']):.5f})" if model.instance_steps else "")
    print(f"    one {FAMILY_SERVE_HW}x{FAMILY_SERVE_HW} request{steps}: {out['time']:.3f} s")
    return {"request_s": out["time"], "steps": n}


def cidnet_serving(gen, smi: str) -> dict:
    """hvi_cidnet_re at its published width: on the card against the CPU at
    1x128x128 (float32, TF32 off); through ``Predictor`` at 2x736x1280 in
    bf16 and float32 (TF32 off), host clock over 3 batches after a warm-up,
    one batch profiled; bf16 held to float32 (TOL_CIDNET_BF16_MEAN on the
    mean |d|, TOL_CIDNET_BF16_MAX on the max, x max(1, max|ref|))."""
    cpu = build_model("hvi_cidnet_re", device="cpu", seed=6)
    if cpu.param_count() != CIDNET_PARAMS:
        fail(f"hvi_cidnet_re has {cpu.param_count()} params, not {CIDNET_PARAMS}")
    card = copy.deepcopy(cpu).to(device="cuda")
    x = torch.from_numpy(gen.uniform(0, 0.4, (1, 128, 128, 3)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            out = card.apply({"image": x.cuda()})["enhanced"].cpu()
            ref = cpu.apply({"image": x})["enhanced"]
        err = (out - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        print(f"  hvi_cidnet_re card vs CPU at 1x128x128, float32, TF32 off: max|d|={err:.3e} "
              f"(tol {TOL_MODEL_F32 * scale:.3e})")
        if not err <= TOL_MODEL_F32 * scale:
            fail("hvi_cidnet_re on the card disagrees with the CPU")
        bench, outs = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            gc.collect()
            bench[str(dtype)[6:]], outs[dtype] = bench_family(card, dtype, "hvi_cidnet_re")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    d = (outs[torch.bfloat16] - outs[torch.float32]).abs()
    scale = max(1.0, outs[torch.float32].abs().max().item())
    bench["bfloat16"]["vs_float32"] = {"max_abs": d.max().item(), "mean_abs": d.mean().item()}
    print(f"  bf16 vs float32 serving: max|d|={d.max().item():.4e} (tol "
          f"{TOL_CIDNET_BF16_MAX * scale:.4e}), mean|d|={d.mean().item():.4e} (tol "
          f"{TOL_CIDNET_BF16_MEAN * scale:.4e}); {smi}")
    if not (d.max().item() <= TOL_CIDNET_BF16_MAX * scale
            and d.mean().item() <= TOL_CIDNET_BF16_MEAN * scale):
        fail("hvi_cidnet_re's bf16 serving disagrees with its float32 serving")
    return {"bench": bench, "vs_cpu_max_abs": err}


def bench_family(model, dtype, name: str, shape=UFORMER_BENCH, n: int = 3) -> tuple:
    """``model`` at ``shape`` through a ``Predictor``: host clock over ``n``
    synchronised batches after a warm-up, peak memory, one batch under
    torch.profiler (its device time, and the share of the timed batch that
    leaves the device idle)."""
    label = f"{name}_{str(dtype)[6:]}"
    pred = Predictor(model, bf16=dtype == torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 0.4, shape).astype(
        np.float32)).cuda()
    out = pred.infer({"image": x})
    check_out(out, shape, unit=False)
    first = out["enhanced"].cpu()
    del out
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        pred.infer({"image": x})
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    _, table, device_ms = profiled(lambda: pred.infer({"image": x}), label)
    print("\n".join(table.splitlines()[:12] + table.splitlines()[-3:]))
    mps = shape[0] * shape[1] * shape[2] / 1e6 / dt
    idle = max(0.0, 1.0 - device_ms / (dt * 1e3))
    print(f"  {name} {'x'.join(map(str, shape[:3]))} {str(dtype)[6:]}: {mps:.3f} MP/s, "
          f"{dt * 1e3:.3f} ms per batch (host clock over {n}), peak {peak / 2**30:.3f} GiB; "
          f"device {device_ms:.3f} ms in the profiled batch (idle share of the host clock's "
          f"batch {idle:.3f})")
    return {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "device_ms": device_ms,
            "idle_share": idle, "peak_gib": peak / 2**30}, first


def cidnet_train(gen, smi: str) -> dict:
    """configs/hvi_cidnet_re_lol_v1.py's step at its batch, 1x256x256: Adam
    under the gradual warm-up into cosine restarts, float32 with torch's
    default TF32 flags, timed as the other train rows."""
    from enhax_torch.utils.config import load_config
    cfg = load_config(CONFIGS / CIDNET_CONFIG)
    b, hw = cfg["data_cfg"]["batch_size"], cfg["image_size"]
    model = build_model("hvi_cidnet_re", seed=cfg["seed"], **cfg["model_cfg"])
    batch = {k: v.cuda() for k, v in family_batch("hvi_cidnet_re", b, hw, gen).items()}
    with default_tf32():
        return time_train_step("hvi_cidnet_re_f32", model, batch, cfg["optimizer_cfg"], None,
                               False, smi, remat=False, ema_decay=None)


def phase_llie_families(gen, smi: str) -> dict:
    """Slice 15, no kernel of the port (the JAX package computes these
    models in XLA): each family's shipped config (``FAMILY_CONFIGS``) held
    to the CPU on its first step (``families_vs_cpu``); hvi_cidnet_re at
    its published width served and its config's train step timed;
    lyt_net_re's full-image attention served at 2x736x1280 in float32; each
    config for FAMILY_TRAIN_STEPS steps at its batch and crop; one served
    request each at 512^2 (zero_ig_re through the instance route at its
    instance_steps). Kernel counts reset before and read after: none may
    launch."""
    t0 = time.perf_counter()
    reset_counts()
    print("[families] one config a family: the first step on the card against the CPU")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        first = families_vs_cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    print("[families] hvi_cidnet_re at the published width")
    cidnet = cidnet_serving(gen, smi)
    cidnet["train"] = cidnet_train(gen, smi)
    gc.collect()
    print("[families] lyt_net_re 2x736x1280 float32 (its attention over 96x160 pooled tokens)")
    with tf32_off():
        lyt, _ = bench_family(build_model("lyt_net_re", seed=1), torch.float32, "lyt_net_re",
                              n=2)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] one config a family: {FAMILY_TRAIN_STEPS} steps, one "
          f"{FAMILY_SERVE_HW}^2 request")
    train = {config: family_steps(config, over, gen, smi) for config, over in FAMILY_CONFIGS}
    if any(counts().values()):
        fail(f"a family launched a kernel of the port: {counts()}")
    phase_s = time.perf_counter() - t0
    print(f"  phase {phase_s:.1f} s")
    for config, row in train.items():
        row["first_step"] = first[config]
    return {"hvi_cidnet_re": cidnet, "lyt_net_re_2x736x1280_float32": lyt, "configs": train,
            "phase_s": phase_s}


# -- the small zero-reference low-light models --------------------------------------

# the six that train, then the two parameter-free ones (LIME served as DUAL
# with the host's direct solve, its default)
ZERO_REF_TRAINABLE = ("zero_didce", "sgz", "sci", "ruas", "pairlie", "rsfnet")
ZERO_REF_NAMES = ZERO_REF_TRAINABLE + ("lime", "pie")
ZERO_REF_CHECK_HW = 128
ZERO_REF_TRAIN_BATCH = (8, 256, 256, 3)
ZERO_REF_TRAIN_STEPS = 3
ZERO_REF_SERVE_HW = 512
SGZ_BENCH = (4, 1088, 1920, 3)         # bench_all.py's 1080p batch, padded to 1092 by 12
SGZ_CPU_SHAPE = (2, 264, 480, 3)       # the card against the CPU, float32
SGZ_ODD_HW = (517, 389)                # not multiples of 12: padded to 528x396
# SGZ's bf16 serving against its float32 serving, max|d| / max(1, max|ref|):
# the CPU's bf16 reads 3.0e-3-3.4e-3 at 2x264x480 (three draws), the input,
# the curve net's convs and the output each rounded to bf16
TOL_SGZ_BF16 = 1e-2
SGZ_BENCH_BATCHES = 3


def zero_ref_image(gen, b: int, hw: int) -> torch.Tensor:
    """A batch of low-light images: ``smooth_image`` draws in [0.02, 0.3]."""
    return torch.from_numpy(np.concatenate([smooth_image(gen, hw, 3, 0.02, 0.3)
                                            for _ in range(b)]))


def zero_ref_first_steps(gen, smi: str) -> dict:
    """Each trainable name's first train step on the card against the CPU's
    on the same weights and one ZERO_REF_CHECK_HW^2 image (``family_check``,
    TF32 off)."""
    rows = {}
    for name in ZERO_REF_TRAINABLE:
        batch = {"image": zero_ref_image(gen, 1, ZERO_REF_CHECK_HW)}
        t0 = time.perf_counter()
        gaps, bounds, (loss, ref_loss) = family_check(name, {}, 0, batch)
        print(f"  {name} 1x{ZERO_REF_CHECK_HW}^2, first step card vs CPU: loss {loss:.6f} / "
              f"{ref_loss:.6f}, gaps {gaps} (bounds {bounds}); {time.perf_counter() - t0:.1f} s; "
              f"{smi}")
        if not all(gaps[k] <= bounds[k] for k in bounds):
            fail(f"{name}: the card's first train step disagrees with the CPU's: {gaps}")
        rows[name] = {**gaps, "bounds": bounds}
    return rows


def zero_ref_steps(name: str, gen, smi: str) -> dict:
    """ZERO_REF_TRAIN_STEPS Adam steps (lr 1e-4) at ZERO_REF_TRAIN_BATCH on
    the card, float32 with torch's default TF32 flags: host clock,
    synchronised, finite losses, peak memory; no curve kernel in a step."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import Trainer
    b, hw = ZERO_REF_TRAIN_BATCH[0], ZERO_REF_TRAIN_BATCH[1]
    model = build_model(name, seed=1)
    batch = {"image": zero_ref_image(gen, b, hw).cuda()}
    tr = Trainer(model, build_optimizer({"optimizer": {"name": "adam", "lr": 1e-4}}))
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    with default_tf32():
        for _ in range(ZERO_REF_TRAIN_STEPS):
            t1 = time.perf_counter()
            losses.append(tr._train_step(state, batch)["loss"].item())
            times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = counts()
    print(f"  {name} {b}x{hw}^2, {ZERO_REF_TRAIN_STEPS} steps: losses {losses}, "
          f"{' / '.join(f'{t * 1e3:.1f}' for t in times)} ms (host clock, synchronised, the "
          f"first with cuDNN's search), peak {peak:.2f} GiB; kernel launches "
          f"{sum(launched.values())}; {smi}")
    if not all(np.isfinite(losses)):
        fail(f"{name}: a train step's loss is not finite: {losses}")
    if any(launched.values()):
        fail(f"{name}: a train step launched a kernel: {launched}")
    del model, state, tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": list(ZERO_REF_TRAIN_BATCH[:3]), "losses": losses,
            "step_ms": [t * 1e3 for t in times], "peak_gib": peak}


def zero_ref_serve(name: str, gen, smi: str) -> dict:
    """One ZERO_REF_SERVE_HW^2 request through ``Predictor`` (float32, TF32
    off; RSFNet fits its instance steps, INSTANCE_REQUEST_STEPS where cut):
    host clock, synchronised, after a warm-up request of the same shape
    (RSFNet: none, its request is the fit), peak memory; SGZ launches
    ``fused_curve_apply`` once, the others no kernel."""
    model = build_model(name, seed=2)
    steps = INSTANCE_REQUEST_STEPS.get(name, model.instance_steps)
    if model.instance_steps:
        model = dataclasses.replace(model, instance_steps=steps)
    pred = Predictor(model)
    x = smooth_image(gen, ZERO_REF_SERVE_HW, 3, 0.02, 0.3)
    if not model.instance_steps:
        pred.infer({"image": x})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pred.infer({"image": x})
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out_time = out["time"]
    check_out(out, x.shape, unit=name in ("lime", "pie", "sci"))
    want = {k: int(name == "sgz" and k == DCE[1]) for k in KERNELS}
    cut = (f", {steps} of its {build_model(name, device='cpu').instance_steps} fit steps "
           f"({request_s * 1e3 / steps:.2f} ms a step), fit_loss {float(out['fit_loss']):.5f}"
           if model.instance_steps else "")
    print(f"  {name} {ZERO_REF_SERVE_HW}^2 request: {request_s:.3f} s (Predictor's own "
          f"{out['time']:.3f} s){cut}; peak {peak:.3f} GiB; launches "
          f"{ {k: v for k, v in launched.items() if v} }; {smi}")
    if launched != want:
        fail(f"{name}: a request launched {launched}, expected {want}")
    want_apply_paths(f"{name}'s request", "vec", want[DCE[1]])
    del pred, model, out
    torch.cuda.empty_cache()
    return {"request_s": request_s, "predictor_s": out_time, "steps": steps,
            "peak_gib": peak, "launches": launched[DCE[1]]}


def sgz_kernel_checks(gen) -> float:
    """``fused_curve_apply`` in its shared form against its plain version at
    SGZ's shapes: the bench batch padded to 4x1092x1920, and an odd
    request's 1x528x396, float32 and bf16. Returns max|d| in float32."""
    err = 0.0
    for n, h, w in ((4, 1092, 1920), (1, 528, 396)):
        for dtype in (torch.float32, torch.bfloat16):
            x = rand(gen, (n, h, w, 3), 0, 0.3, dtype)
            r = rand(gen, (n, h, w, 3), -1, 1, dtype)
            e = compare(DCE[1], (x, r), {"num_iters": 8, "shared": True})
            if dtype == torch.float32:
                err = max(err, e)
    return err


def sgz_serving(gen, smi: str) -> dict:
    """SGZ at its published width through ``Predictor``: on the card against
    the CPU at SGZ_CPU_SHAPE (float32, TF32 off, TOL_MODEL_F32 x max(1,
    max|ref|)); an odd request (SGZ_ODD_HW, padded to 12s); then
    SGZ_BENCH in bf16 and float32, host clock over SGZ_BENCH_BATCHES
    synchronised batches after a warm-up, peak memory, SGZ_BENCH_BATCHES
    batches under torch.profiler (CUDA events where it records no device
    time), ``fused_curve_apply`` launched once a request; bf16
    held to float32 (TOL_SGZ_BF16 x max(1, max|ref|) on the max)."""
    cpu = build_model("sgz", device="cpu", seed=3)
    card = copy.deepcopy(cpu).to(device="cuda")
    x = np.concatenate([smooth_image(gen, SGZ_CPU_SHAPE[2], 3, 0.02, 0.3)[:, :SGZ_CPU_SHAPE[1]]
                        for _ in range(SGZ_CPU_SHAPE[0])])
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    launches = 0
    try:
        reset_counts()
        out = Predictor(card).infer({"image": x})
        launches += counts()[DCE[1]]
        want_apply_paths("sgz's request against the CPU", "vec", 1)
        ref = Predictor(cpu, device="cpu").infer({"image": x})
        err = {k: (out[k].cpu() - ref[k]).abs().max().item() / max(1.0, ref[k].abs().max().item())
               for k in ("enhanced", "adjust")}
        odd = gen.uniform(0.02, 0.3, SGZ_ODD_HW + (3,)).astype(np.float32)
        reset_counts()
        out_odd = Predictor(card).infer({"image": odd})
        c_odd = counts()[DCE[1]]
        launches += c_odd
        want_apply_paths("sgz's odd request", "vec", 1)
        ref_odd = Predictor(cpu, device="cpu").infer({"image": odd})
        err["odd"] = ((out_odd["enhanced"].cpu() - ref_odd["enhanced"]).abs().max().item()
                      / max(1.0, ref_odd["enhanced"].abs().max().item()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"  sgz card vs CPU, float32, TF32 off: {SGZ_CPU_SHAPE} {err} (tol {TOL_MODEL_F32}); "
          f"{SGZ_ODD_HW} padded to 12s: output {tuple(out_odd['enhanced'].shape)}, "
          f"fused_curve_apply launches {c_odd}; {smi}")
    if not all(v <= TOL_MODEL_F32 for v in err.values()):
        fail(f"sgz on the card disagrees with the CPU: {err}")
    check_out(out_odd, (1,) + SGZ_ODD_HW + (3,), unit=False)
    if c_odd != 1:
        fail(f"sgz's odd request launched fused_curve_apply {c_odd} times")
    bench, outs = {}, {}
    xb = torch.from_numpy(np.random.default_rng(8).uniform(0, 0.3, SGZ_BENCH).astype(
        np.float32)).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        gc.collect()
        label = str(dtype)[6:]
        pred = Predictor(card, bf16=dtype == torch.bfloat16)
        first = pred.infer({"image": xb})
        outs[dtype] = first["enhanced"].cpu()
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per = []
        t0 = time.perf_counter()
        for _ in range(SGZ_BENCH_BATCHES):
            reset_counts()
            pred.infer({"image": xb})
            per.append(counts()[DCE[1]])
            want_apply_paths(f"sgz's {label} batch", "vec", 1)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SGZ_BENCH_BATCHES
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches += sum(per)
        # SGZ_BENCH_BATCHES batches under the profiler: one batch of ~1 ms
        # came back with no device events in one whole run of this script
        reset_counts()
        averages, table, device_ms = profiled(
            lambda: [pred.infer({"image": xb}) for _ in range(SGZ_BENCH_BATCHES)], f"sgz_{label}")
        profiled_launches = counts()[DCE[1]]
        want_apply_paths(f"sgz's profiled {label} batches", "vec", SGZ_BENCH_BATCHES)
        launches += profiled_launches
        device_ms /= SGZ_BENCH_BATCHES
        kernel_ms = sum(e.self_device_time_total for e in averages
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "curve_apply" in e.key) / 1e3 / SGZ_BENCH_BATCHES
        mps = SGZ_BENCH[0] * SGZ_BENCH[1] * SGZ_BENCH[2] / 1e6 / dt
        print("\n".join(table.splitlines()[:12] + table.splitlines()[-3:]))
        if device_ms > 0:
            idle = max(0.0, 1.0 - device_ms / (dt * 1e3))
            device = (f"profiled batches: device {device_ms:.3f} ms a batch (idle share "
                      f"{idle:.3f}), the curve kernel {kernel_ms:.4f} ms")
        else:   # the profiler recorded no device time: the stream's time by CUDA events
            idle, events_ms = None, cuda_ms(lambda: pred.infer({"image": xb}), iters=3)
            device = (f"the profiler recorded no device time; CUDA events {events_ms:.3f} ms a "
                      "batch (the stream's time, idle gaps included; idle share not measured)")
        print(f"  sgz {'x'.join(map(str, SGZ_BENCH[:3]))} {label}: {mps:.3f} MP/s, "
              f"{dt * 1e3:.3f} ms a batch (host clock over {SGZ_BENCH_BATCHES}), peak {peak:.3f} "
              f"GiB; fused_curve_apply launches a request {per}, {profiled_launches} in the "
              f"profiled batches; {device}; {smi}")
        if per != [1] * SGZ_BENCH_BATCHES or profiled_launches != SGZ_BENCH_BATCHES:
            fail(f"sgz {label}: fused_curve_apply launched {per} / {profiled_launches} times, "
                 "not once a request")
        bench[label] = {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "device_ms": device_ms,
                        "idle_share": idle, "peak_gib": peak, "kernel_device_ms": kernel_ms,
                        "launches_a_request": per}
        del pred
    d = (outs[torch.bfloat16] - outs[torch.float32]).abs()
    scale = max(1.0, outs[torch.float32].abs().max().item())
    bench["bfloat16"]["vs_float32"] = {"max_abs": d.max().item(), "mean_abs": d.mean().item()}
    print(f"  sgz bf16 vs float32 serving: max|d|={d.max().item():.4e} (tol "
          f"{TOL_SGZ_BF16 * scale:.4e}), mean|d|={d.mean().item():.4e}; {smi}")
    if not d.max().item() <= TOL_SGZ_BF16 * scale:
        fail("sgz's bf16 serving disagrees with its float32 serving")
    return {"vs_cpu": err, "bench": bench, "launches": launches}


def sgz_kernel_timing(gen, smi: str) -> dict:
    """``fused_curve_apply`` (shared) at SGZ's bench shape, bf16 and
    float32, by ``apply_turns``: ``ms`` is the wrapper's time as PR 17's
    line read it (8 calls by CUDA events, a fresh output each), beside the
    first design, the device times of 20 launches into one output, the
    plain version and ``torch.add`` of the same bytes; the bound as
    ``phase_timing`` counts it (the image and the curve read once, the
    output written once; 3 flops an element an iteration)."""
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = rand(gen, SGZ_APPLY, 0, 0.3, dtype)
        r = rand(gen, SGZ_APPLY, -1, 1, dtype)
        nbytes = nbytes_of(x, r, x)
        b_ms, b_by = bound(nbytes, x.numel() * 3 * 8)
        t = apply_turns(x, r, True, b_ms)
        ms = t["wrapper"]["fused_curve_apply"]["ms"]
        print(f"  fused_curve_apply {SGZ_APPLY} shared {str(dtype)[6:]}: {ms:.4f} ms through "
              f"the wrapper, {b_ms / ms:.1%} of the {b_ms:.4f} ms bound by {b_by} "
              f"({nbytes / 1e9:.4f} GB); {smi}")
        res[str(dtype)[6:]] = {"shape": list(SGZ_APPLY), "ms": ms,
                               "plain_ms": t["queued"]["plain"]["ms"], "bound_ms": b_ms,
                               "bound_by": b_by, "bytes": nbytes, **t}
    return res


def zero_ref_predict_cli(gen, smi: str) -> dict:
    """The predict CLI over a folder of two 192x256 PNGs for sgz and lime,
    on the card: one image written per input; sgz's curve kernel launched
    once an image (batch 1). (LIME's two host solves an image take ~2 s at
    384x512.)"""
    import tempfile
    import cv2
    from enhax_torch.cli import predict as predict_cli
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "data").mkdir()
        for i in range(2):
            img = (smooth_image(gen, 256, 3, 0.02, 0.3)[0, :192] * 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "data" / f"{i:02d}.png"), img)
        for name in ("sgz", "lime"):
            reset_counts()
            t0 = time.perf_counter()
            predict_cli.main(["--model", name, "--data", str(root / "data"), "--save-dir",
                              str(root / name)])
            s = time.perf_counter() - t0
            c = counts()[DCE[1]]
            want_apply_paths(f"the predict CLI ({name})", "vec", c)
            written = sorted(p.name for p in (root / name).iterdir())
            print(f"  predict CLI {name}, 2 PNGs of 192x256: {s:.1f} s, wrote {written}, "
                  f"fused_curve_apply launches {c}; {smi}")
            if written != ["00.png", "01.png"]:
                fail(f"the predict CLI ({name}) did not write one image per input")
            if c != (2 if name == "sgz" else 0):
                fail(f"the predict CLI ({name}) launched fused_curve_apply {c} times")
            res[name] = {"s": s, "launches": c}
    return res


def phase_llie_zero_ref(gen, smi: str) -> dict:
    """The small zero-reference low-light models. The first train
    step of each trainable name on the card against the CPU
    (``zero_ref_first_steps``); ``fused_curve_apply`` against its plain
    version at SGZ's shapes; each trainable name for ZERO_REF_TRAIN_STEPS
    steps at ZERO_REF_TRAIN_BATCH; one ZERO_REF_SERVE_HW^2 request of each
    of the eight names; SGZ served at the bench shape in bf16 and float32;
    the predict CLI for sgz and lime; the kernel timed at SGZ's shape.
    Counts reset before each drive and read after it: SGZ's serving
    launches the curve kernel once a request, nothing else launches one."""
    t0 = time.perf_counter()
    print("[zero-ref] the first train step on the card against the CPU, float32, TF32 off")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        first = zero_ref_first_steps(gen, smi)
        print("[zero-ref] fused_curve_apply (shared) at SGZ's shapes against its plain version")
        err = sgz_kernel_checks(gen)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"[zero-ref] {ZERO_REF_TRAIN_STEPS} train steps at {ZERO_REF_TRAIN_BATCH}")
    train = {name: zero_ref_steps(name, gen, smi) for name in ZERO_REF_TRAINABLE}
    for name in ZERO_REF_TRAINABLE:
        train[name]["first_step"] = first[name]
    print(f"[zero-ref] one {ZERO_REF_SERVE_HW}^2 request a name")
    serve = {name: zero_ref_serve(name, gen, smi) for name in ZERO_REF_NAMES}
    print(f"[zero-ref] sgz at its published width, {SGZ_BENCH}")
    sgz = sgz_serving(gen, smi)
    cli = zero_ref_predict_cli(gen, smi)
    timing = sgz_kernel_timing(gen, smi)
    launches = sgz["launches"] + serve["sgz"]["launches"] + cli["sgz"]["launches"]
    phase_s = time.perf_counter() - t0
    print(f"  phase {phase_s:.1f} s; fused_curve_apply launches on SGZ's path {launches}; {smi}")
    return {"train": train, "serve": serve, "sgz": sgz, "cli": cli, "kernel_timing": timing,
            "launches": {DCE[1]: launches}, "errs": {DCE[1]: err}, "phase_s": phase_s,
            "card": smi}


# -- Zero-Restore and the metric CLI (slice 19) ----------------------------------

ZERO_RESTORE = (("zero_restore_llie", "zero_restore_llie.py"),
                ("zero_restore_dehaze", "zero_restore_dehaze.py"),
                ("zero_restore_uie", "zero_restore_uie.py"))
ZERO_RESTORE_CHECK_HW = 128
ZERO_RESTORE_SERVE_HW = 512
ZERO_RESTORE_CLI_STEPS = 20    # the predict CLI's fit, cut from 1000 by wrapping build_model
# held in float32 on both devices; everything, the first step's gradients
# and the 3-step fit among it, is held in float64 on both. In float32 the
# gradients' sums over the map part by up to 1.0e-4 of the largest (UIE on
# an H100), and Adam's first step moves each weight by lr x the
# sign of its gradient: where a gradient is within float32 noise of 0 that
# sign is the device's rounding, which the output's division by t amplifies
# (the dehaze / UIE fits' float32 outputs part by 5.6-6.6e-4, their states'
# mean |d| stays within 3.4e-5, on an H100)
ZERO_RESTORE_F32_HELD = ("forward", "loss")


def zero_restore_request(name: str, gen, hw: int) -> dict:
    """The photo a user of ``name`` sends: a low-light one (llie), a hazy
    one (dehaze), an underwater one with its red channel weak (uie)."""
    if name.endswith("llie"):
        x = smooth_image(gen, hw, 3, 0.02, 0.3, noise=0.01)
    elif name.endswith("dehaze"):
        x = smooth_image(gen, hw, 3, 0.45, 0.95, noise=0.01)
    else:
        x = smooth_image(gen, hw, 3, 0.1, 0.8, noise=0.01) * np.float32([0.35, 0.8, 0.9])
    return {"image": x.astype(np.float32)}


@contextlib.contextmanager
def cut_fit(steps: int):
    """Every model ``enhax_torch.models.base.build_model`` builds meanwhile
    fits ``steps`` steps a request (the predict CLI's fit, cut)."""
    from enhax_torch.models import base
    build = base.build_model
    base.build_model = lambda *a, **k: dataclasses.replace(build(*a, **k), instance_steps=steps)
    try:
        yield
    finally:
        base.build_model = build


def zero_restore_checks(gen) -> dict:
    """Zero-Restore's three configs on the card against the CPU at
    1xZERO_RESTORE_CHECK_HW^2 (``instance_model_vs_cpu``, TF32 off): the
    clean forward and the first fit step's loss in float32, and in float64
    those with the first step's gradients and the 3-step fit's fit_loss,
    output and state (``ZERO_RESTORE_F32_HELD``; every float32 gap is
    printed). Correctness only, no clock read:
    ``main`` runs it while the CPU's instance chains finish. Returns
    {name: (float32 result, float64 result)}."""
    t0 = time.perf_counter()
    out, failures = {}, []
    for name, config in ZERO_RESTORE:
        cpu, seed = instance_model(name, config)
        check = zero_restore_request(name, gen, ZERO_RESTORE_CHECK_HW)
        print(f"[zero-restore] {name} ({config}, seed {seed}; {cpu.param_count():,} params) "
              f"on the card against the CPU")
        vs = instance_model_vs_cpu(cpu, check)
        vs64 = instance_model_vs_cpu(
            dataclasses.replace(cpu, module=copy.deepcopy(cpu.module).double()),
            {k: v.astype(np.float64) for k, v in check.items()})
        adam_reach = 2 * 3 * cpu.instance_lr
        for dt, v in (("f32", vs), ("f64", vs64)):
            print(f"  card vs CPU at 1x{ZERO_RESTORE_CHECK_HW}^2 ({dt}, TF32 off): {v['gaps']} "
                  f"(tol {TOL_MODEL_F32}); fitted state max|d| {v['state_max']:.3e} (tol "
                  f"{adam_reach:.1e}), {v['beyond_tol']} of {v['state_n']} elements beyond "
                  f"{TOL_MODEL_F32}; {v['params_moved']} of {v['params']} parameters moved")
        held = {**{k: vs["gaps"][k] for k in ZERO_RESTORE_F32_HELD},
                **{f"{k} (f64)": g for k, g in vs64["gaps"].items()}}
        if not (all(g <= TOL_MODEL_F32 for g in held.values())
                and max(vs["state_max"], vs64["state_max"]) <= adam_reach):
            failures.append(f"{name}: the card disagrees with the CPU {held}, state max|d| "
                            f"{vs['state_max']} / {vs64['state_max']} (f32 / f64)")
        out[name] = (vs, vs64)
    print(f"  checks: {time.perf_counter() - t0:.1f} s")
    if failures:
        fail("; ".join(failures))
    return out


def phase_zero_restore(gen, smi: str, checks: dict) -> dict:
    """Zero-Restore's three instance models at the configs' width (64
    channels: the registry ignores the configs' ``model_cfg``, as the JAX
    package's does) through ``Predictor`` on the card, after
    ``zero_restore_checks`` (``checks``): one timed ZERO_RESTORE_SERVE_HW^2
    request of ``INSTANCE_REQUEST_STEPS`` steps with torch's default TF32
    flags (its fit_loss finite and below the same image's start loss, its
    output finite, no kernel of the port launched); a profiled request of
    INSTANCE_PROFILE_STEPS steps (device ms and launches a step; the idle
    share: 1 - the profiled device ms a step over the timed request's host
    ms a step); then the predict CLI with
    ``--config configs/zero_restore_llie.py`` on one 512x512 PNG, its fit
    cut to ZERO_RESTORE_CLI_STEPS steps (``cut_fit``)."""
    import tempfile
    import cv2
    from enhax_torch.cli import predict as predict_cli
    t_phase = time.perf_counter()
    rows, failures = {}, []
    for name, config in ZERO_RESTORE:
        t_model = time.perf_counter()
        cpu, seed = instance_model(name, config)
        vs, vs64 = checks[name]
        print(f"[zero-restore] {name}: {cpu.instance_steps} steps at lr {cpu.instance_lr}")
        steps = INSTANCE_REQUEST_STEPS[name]
        dp = zero_restore_request(name, gen, ZERO_RESTORE_SERVE_HW)
        card = dataclasses.replace(cpu, module=copy.deepcopy(cpu.module).cuda())
        with torch.no_grad():
            start_loss = float(card.forward_loss(
                {"image": torch.from_numpy(dp["image"]).cuda()})[0])
        pred = Predictor(dataclasses.replace(card, instance_steps=steps), device="cuda")
        with default_tf32():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pred(dp)
            torch.cuda.synchronize()
            request_s = time.perf_counter() - t0
            launched = sum(counts().values())
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            prof = Predictor(dataclasses.replace(card, instance_steps=INSTANCE_PROFILE_STEPS),
                             device="cuda")
            t0 = time.perf_counter()
            averages, table, device_ms = profiled(lambda: prof(dp), f"instance_{name}",
                                                  ops=False)
            prof_s = time.perf_counter() - t0
        ops = sum(e.count for e in averages if e.key.startswith("cudaLaunchKernel"))
        y = out["enhanced"]
        fit_loss = float(out["fit_loss"])
        row = {"config": config, "seed": seed, "params": cpu.param_count(), "steps": steps,
               "instance_steps": cpu.instance_steps, "lr": cpu.instance_lr,
               "vs_cpu": vs["gaps"], "vs_cpu_f64": vs64["gaps"], "state_max": vs["state_max"],
               "state_beyond_tol": vs["beyond_tol"], "params_moved_3_steps": vs["params_moved"],
               "request_s": request_s, "predictor_s": out["time"],
               "ms_a_step": request_s * 1e3 / steps, "peak_gib": peak,
               "start_loss": start_loss, "fit_loss": fit_loss,
               "out_min": float(y.min()), "out_max": float(y.max()),
               "kernel_launches": launched, "profiled_steps": INSTANCE_PROFILE_STEPS,
               "profiled_s": prof_s, "profiled_device_ms": device_ms,
               "device_ms_a_step": device_ms / INSTANCE_PROFILE_STEPS,
               "launches_a_step": ops / INSTANCE_PROFILE_STEPS,
               "idle_share": max(0.0, 1.0 - device_ms / INSTANCE_PROFILE_STEPS
                                 / (request_s * 1e3 / steps)), "card": smi}
        print(f"  one {ZERO_RESTORE_SERVE_HW}^2 request of {steps} of its "
              f"{cpu.instance_steps} steps (torch's default TF32 flags): {request_s:.3f} s "
              f"(Predictor's own {out['time']:.3f} s), {row['ms_a_step']:.2f} ms a step; peak "
              f"{peak:.3f} GiB; fit_loss {fit_loss:.6f} (start {start_loss:.6f}); output in "
              f"[{row['out_min']:.4f}, {row['out_max']:.4f}]; kernel launches {launched}; "
              f"profiled request of {INSTANCE_PROFILE_STEPS} steps: {prof_s:.3f} s, device "
              f"{device_ms:.3f} ms ({row['device_ms_a_step']:.3f} a step, "
              f"{row['launches_a_step']:.0f} launches a step; the idle share of the timed "
              f"request's step {row['idle_share']:.3f}); {smi}")
        print("\n".join(table.splitlines()[:12]))
        if not (torch.isfinite(y).all() and np.isfinite(fit_loss) and fit_loss < start_loss):
            failures.append(f"{name}: fit_loss {fit_loss} not finite or not below the start "
                            f"loss {start_loss}, or the output not finite")
        if tuple(y.shape) != (1, ZERO_RESTORE_SERVE_HW, ZERO_RESTORE_SERVE_HW, 3):
            failures.append(f"{name}: output {tuple(y.shape)}")
        if launched:
            failures.append(f"{name}: a request launched a kernel of the port ({launched})")
        row["model_s"] = time.perf_counter() - t_model
        rows[name] = row
        del pred, prof, out, card
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "data").mkdir()
        img = zero_restore_request("zero_restore_llie", gen, ZERO_RESTORE_SERVE_HW)["image"][0]
        cv2.imwrite(str(root / "data" / "00.png"), (img[..., ::-1] * 255).round().astype(np.uint8))
        reset_counts()
        t0 = time.perf_counter()
        with cut_fit(ZERO_RESTORE_CLI_STEPS):
            predict_cli.main(["--config", str(CONFIGS / "zero_restore_llie.py"), "--data",
                              str(root / "data"), "--save-dir", str(root / "out")])
        cli_s = time.perf_counter() - t0
        written = sorted(p.name for p in (root / "out").iterdir())
        from enhax_torch.ops.io import read_image
        got = read_image(root / "out" / "00.png") if written == ["00.png"] else None
        print(f"  predict CLI --config configs/zero_restore_llie.py, one "
              f"{ZERO_RESTORE_SERVE_HW}^2 PNG, the fit cut to {ZERO_RESTORE_CLI_STEPS} of 1000 "
              f"steps: {cli_s:.1f} s, wrote {written}; kernel launches "
              f"{sum(counts().values())}; {smi}")
        if got is None or got.shape != (ZERO_RESTORE_SERVE_HW, ZERO_RESTORE_SERVE_HW, 3) \
                or not np.isfinite(got).all() or sum(counts().values()):
            failures.append("the predict CLI did not serve zero_restore_llie's config")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase: {phase_s:.1f} s")
    if failures:
        fail("; ".join(failures))
    return {"models": rows, "predict_cli_s": cli_s, "predict_cli_steps": ZERO_RESTORE_CLI_STEPS,
            "phase_s": phase_s}


METRIC_HW = 512
METRIC_PAIRS = 4
METRIC_EXTENDED = ("uiqi", "vif", "scc", "spectral_angle_mapper", "ergas", "rase", "rmse_sw",
                   "psnrb", "total_variation")
METRIC_SEG_CLASSES = 19
# the card's means against the CPU's, x max(1, |cpu|): float32 sums in other
# orders; NIQE and BRISQUE look moment ratios up on a grid 0.001 apart, and
# a ratio at a near tie of two grid points may take the other on the other
# device (one step moved a NIQE score by up to 0.76% and a BRISQUE proxy by
# 4.9e-4 in the CPU tests); the segmentation's counts are exact
METRIC_TOL = {"fr": 1e-4, "niqe": 2e-2, "brisque": 1e-3, "segment": 1e-12}


def metric_folder(root: Path, gen) -> None:
    """``res/`` and ``tgt/`` with METRIC_PAIRS pairs of METRIC_HW^2 PNGs (a
    target photo and its result, noisier and darker), ``pristine/`` with
    four photos, ``pred/`` and ``gt/`` with as many 19-class label maps
    (blobs, the prediction a noisy copy)."""
    import cv2
    for d in ("res", "tgt", "pred", "gt"):
        (root / d).mkdir()
    for i in range(METRIC_PAIRS):
        tgt = smooth_image(gen, METRIC_HW, 3, 0.05, 0.95, noise=0.02)[0]
        res = np.clip(0.9 * tgt + gen.normal(0, 0.04, tgt.shape), 0, 1)
        for d, a in (("tgt", tgt), ("res", res)):
            cv2.imwrite(str(root / d / f"{i:02d}.png"),
                        (a[..., ::-1] * 255).round().astype(np.uint8))
        gt = (smooth_image(gen, METRIC_HW, 1, 0, 1)[0, ..., 0] * METRIC_SEG_CLASSES).astype(
            np.uint8).clip(0, METRIC_SEG_CLASSES - 1)
        pred = np.where(gen.uniform(size=gt.shape) < 0.8, gt,
                        gen.integers(0, METRIC_SEG_CLASSES, gt.shape)).astype(np.uint8)
        cv2.imwrite(str(root / "gt" / f"{i:02d}.png"), gt)
        cv2.imwrite(str(root / "pred" / f"{i:02d}.png"), pred)


def phase_metric_cli(gen, smi: str) -> dict:
    """The metric CLI on the card over a folder of METRIC_PAIRS
    METRIC_HW^2 result / target pairs (``metric_folder``): every extended
    full-reference metric in one run; ``niqe`` with params fitted on the
    card by ``fit_niqe_params`` (four pristine photos) and with an
    official-layout ``.npz`` written from them (BasicSR's names, the
    fspecial window; the official pipeline); ``brisque`` with a synthetic
    libsvm ``.npz`` (40 support vectors, the ranges from the results'
    features) and without one (the proxy); ``--task segment`` on 19-class
    label maps. Each run's seconds on the card; each mean held to the same
    run with ``--device cpu`` (METRIC_TOL)."""
    import tempfile
    from enhax_torch.cli import metric as metric_cli
    from enhax_torch.nn.brisque import brisque_features
    from enhax_torch.nn.niqe import _fspecial_gaussian_np, fit_niqe_params
    from enhax_torch.ops.io import read_image
    t_phase = time.perf_counter()
    rows, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        metric_folder(root, gen)
        pristine = [torch.from_numpy(smooth_image(gen, METRIC_HW, 3, 0.05, 0.95, noise=0.02)[0])
                    .cuda() for _ in range(4)]
        fitted = fit_niqe_params(pristine)
        np.savez(root / "fitted.npz", mu=fitted["mu"], cov=fitted["cov"], impl="self")
        np.savez(root / "niqe_pris_params.npz",
                 mu_pris_param=fitted["mu"][None].astype(np.float64),
                 cov_pris_param=fitted["cov"].astype(np.float64) + 1e-3 * np.eye(36),
                 gaussian_window=_fspecial_gaussian_np())
        feats = np.stack([brisque_features(torch.from_numpy(read_image(p)).cuda()).cpu().numpy()
                          for p in sorted((root / "res").iterdir())])
        np.savez(root / "svm.npz", sv=gen.uniform(-1, 1, (40, 36)), coef=gen.normal(0, 1, 40),
                 rho=np.float64(0.3), gamma=np.float64(0.05), lo=feats.min(0) - 0.1,
                 hi=feats.max(0) + 0.1)
        fr = ["--input", str(root / "res"), "--target", str(root / "tgt")]
        nr = ["--input", str(root / "res")]
        runs = {
            "extended": ("fr", fr + [a for m in METRIC_EXTENDED for a in ("--metric", m)]),
            "niqe_fitted": ("niqe", nr + ["--metric", "niqe", "--niqe-params",
                                          str(root / "fitted.npz")]),
            "niqe_official": ("niqe", nr + ["--metric", "niqe", "--niqe-params",
                                            str(root / "niqe_pris_params.npz")]),
            "brisque_svm": ("brisque", nr + ["--metric", "brisque", "--brisque-svm",
                                             str(root / "svm.npz")]),
            "brisque_proxy": ("brisque", nr + ["--metric", "brisque"]),
            "segment": ("segment", ["--task", "segment", "--input", str(root / "pred"),
                                    "--target", str(root / "gt"), "--seg-classes",
                                    str(METRIC_SEG_CLASSES), "--metric", "miou", "--metric",
                                    "mpa", "--metric", "pa", "--metric", "fwiou"]),
        }
        for run, (kind, argv) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = metric_cli.main(argv)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = metric_cli.main(argv + ["--device", "cpu"])
            cpu_s = time.perf_counter() - t0
            gaps = {m: abs(card[m] - cpu[m]) / max(1.0, abs(cpu[m])) for m in cpu}
            rows[run] = {"card": card, "cpu": cpu, "gaps": gaps, "card_s": card_s,
                         "cpu_s": cpu_s, "tol": METRIC_TOL[kind]}
            print(f"[metric CLI] {run}: card {card_s:.2f} s, CPU {cpu_s:.2f} s; card {card}; "
                  f"gaps to the CPU {gaps} (tol {METRIC_TOL[kind]}); {smi}")
            if list(card) != list(cpu) or not all(np.isfinite(v) and gaps[m] <= METRIC_TOL[kind]
                                                  for m, v in card.items()):
                failures.append(f"{run}: the card's means {card} against the CPU's {cpu}")
    card_s = sum(r["card_s"] for r in rows.values())
    phase_s = time.perf_counter() - t_phase
    print(f"  the metric CLI's runs on the card over {METRIC_PAIRS} pairs of {METRIC_HW}^2: "
          f"{card_s:.2f} s; phase {phase_s:.1f} s")
    if failures:
        fail("; ".join(failures))
    return {"runs": rows, "card_s": card_s, "phase_s": phase_s, "card": smi}


# -- the last multitask models: MPRNet, AirNet with its DCNv2, AdaIR ----------------

MULTITASK = ("mprnet", "airnet", "adair")
# the published widths' parameter counts, the JAX package's (``jax.eval_shape``
# of its init; AirNet's 384 BatchNorm statistics are buffers here)
MULTITASK_PARAMS = {"mprnet": 20_127_127, "airnet": 6_329_609, "adair": 28_766_086}
# each model's papers' crop, at batch 4: MPRNet's 256^2, AirNet's and AdaIR's 128^2
MULTITASK_TRAIN = {"mprnet": (4, 256), "airnet": (4, 128), "adair": (4, 128)}
MULTITASK_TRAIN_STEPS = 3
# the card against the CPU on one 64x64 pair: each model at its published
# width, and AdaIR also with fre_n 8, whose frequency boxes can be non-empty
# at that size (h // 128 = 0 below 128 rows: the default's never are)
MULTITASK_CHECKS = (("mprnet", {}), ("airnet", {}), ("adair", {}), ("adair", {"fre_n": 8}))
MULTITASK_CHECK_HW = 64
MULTITASK_SEED = 30
MULTITASK_CPU_THREADS = 2
# a frequency box's products (h // n) * rate at least this far from an
# integer on the CPU, so that a flipped truncation reads as a flip
MULTITASK_BOX_MARGIN = 1e-3
MULTITASK_SERVE = UFORMER_BENCH
# bf16 serving against float32 at MULTITASK_SERVE: the mean |d| within this x
# max(1, max|ref|) (HVI-CIDNet's bound on the max). HINet's 3e-2 on the max
# read 0.81 (mprnet), 0.25 (airnet) and 0.049 (adair) on the card at their
# random published-width weights, where the CPU's own bf16 read 0.087 /
# 0.084 / 0.062 at 1x64x64 (an H100's first reading of this phase, before
# cuDNN was turned back on and AirNet's offsets zeroed; since then 0.546 /
# 0.037 / 0.058): rounding compounds over ~100 convs of growing activations. The bf16 path itself is held at 1x64x64, against the
# CPU's own bf16 on the same weights and input (``multitask_checks``)
TOL_MULTITASK_BF16_MEAN = 0.3


def multitask_label(name: str, kw: dict) -> str:
    return name + "".join(f"[{k}={v}]" for k, v in kw.items())


def multitask_batch(label: str, seed: int, b: int = 1, hw: int = MULTITASK_CHECK_HW) -> dict:
    """A degraded image and its reference (b, hw, hw, 3), from a generator
    seeded by the label and ``seed``."""
    gen = np.random.default_rng([zlib.crc32(label.encode()), seed])
    ref = gen.uniform(0.05, 0.95, (b, hw, hw, 3)).astype(np.float32)
    img = ref * gen.uniform(0.4, 1.0, (b, 1, 1, 1)) + gen.normal(0, 0.05, ref.shape)
    return {"image": torch.from_numpy(img.clip(0, 1).astype(np.float32)),
            "ref_image": torch.from_numpy(ref)}


def frequency_products(model, image: torch.Tensor) -> dict:
    """AdaIR's FreModules' (h // n) * rate, (B, 2) each, and the boxes'
    half-sizes, from one forward (hooks on the rate MLP's logits)."""
    from enhax_torch.models.multitask.adair import frequency_box
    seen, sizes = {}, {}

    def size(name):
        def fn(module, args):
            sizes[name] = args[1].shape[1:3]   # the feature map's (h, w)
        return fn

    def rates(name, n):
        def fn(module, args, out):
            rate = torch.sigmoid(out.detach())[:, 0, 0, :]
            h, w = sizes[name]
            seen[name] = {"products": (rate.double().cpu() * torch.tensor(
                [h // n, w // n], dtype=torch.float64)).numpy(),
                "box": [t.tolist() for t in frequency_box(rate, h, w, n)]}
        return fn

    handles = []
    for name in ("fre1", "fre2", "fre3"):
        fre = getattr(model.module, name)
        handles.append(fre.register_forward_pre_hook(size(name)))
        handles.append(fre.rate_conv[2].register_forward_hook(rates(name, fre.n)))
    try:
        with torch.no_grad():
            model.apply({"image": image})
    finally:
        for h in handles:
            h.remove()
    return seen


def boxes_clear(products: dict) -> bool:
    """Every product with a nonzero h // n (or w // n) at least
    MULTITASK_BOX_MARGIN from an integer."""
    return all(abs(p - round(p)) >= MULTITASK_BOX_MARGIN
               for rec in products.values() for p in rec["products"].ravel() if p != 0.0)


def multitask_step(model, batch: dict) -> dict:
    """The served forward (every output, running statistics), then a
    training step's outputs, loss, every gradient and the floating buffers
    after it: on the batch's statistics where the module takes ``train``
    (the Trainer's float32 step), else ``forward_loss``."""
    with torch.no_grad():
        served = {k: v.detach().cpu() for k, v in model.apply(batch).items()}
    model.module.zero_grad(set_to_none=True)
    if model.accepts_train:
        outputs = model.apply(batch, training=True, batch_stats=True)
        loss = model.loss_fn(outputs, batch)
    else:
        loss, outputs = model.forward_loss(batch)
    loss.backward()
    out = {"served": served, "outputs": {k: v.detach().cpu() for k, v in outputs.items()},
           "loss": loss.item(),
           "grads": {k: p.grad.detach().cpu() for k, p in model.module.named_parameters()
                     if p.grad is not None},
           "stats": {k: b.detach().cpu().clone() for k, b in model.module.named_buffers()
                     if b.is_floating_point()}}
    model.module.zero_grad(set_to_none=True)
    return out


def multitask_bf16_gap(model, batch: dict) -> float:
    """max|bf16 - float32| / max(1, max|float32|) of ``enhanced`` through
    ``Predictor`` on the model's device."""
    dev = next(model.module.parameters()).device
    outs = [Predictor(model, device=dev, bf16=b).infer({"image": batch["image"]})["enhanced"]
            for b in (False, True)]
    return ((outs[1] - outs[0]).abs().max() / max(1.0, outs[0].abs().max().item())).item()


def multitask_reference(path: str) -> None:
    """The CPU's side of the multitask checks (run in a process of its own,
    started before the build): for each of MULTITASK_CHECKS, the batch (for
    AdaIR the first seed whose boxes are ``boxes_clear``), the frequency
    products, ``multitask_step`` in float32 (and in float64 where the float32
    gradients part from it further than TOL_MODEL_F32) and the CPU's own
    bf16 gap on the batch; saved to ``path``."""
    torch.set_num_threads(MULTITASK_CPU_THREADS)
    refs = {}
    for name, kw in MULTITASK_CHECKS:
        label = multitask_label(name, kw)
        t0 = time.perf_counter()
        model = build_model(name, device="cpu", seed=MULTITASK_SEED, **kw)
        seed, batch, products = 0, multitask_batch(label, 0), None
        if name == "adair":
            for seed in range(20):
                batch = multitask_batch(label, seed)
                products = frequency_products(model, batch["image"])
                if boxes_clear(products):
                    break
            else:
                raise RuntimeError(f"{label}: no input with its boxes clear of a truncation")
        ref = {"seed": seed, "batch": batch, "products": products,
               "bf16_gap": multitask_bf16_gap(model, batch),
               "float32": multitask_step(model, batch)}
        # float64 where the CPU's own float32 gradients part from it (the
        # card's float32 will then part from the CPU's too), kept for the
        # card's side in the float64 rule of ``multitask_checks``
        m64 = build_model(name, device="cpu", seed=MULTITASK_SEED, dtype=torch.float64, **kw)
        f64 = multitask_step(m64, {k: v.double() for k, v in batch.items()})
        if max(tensor_gaps(ref["float32"]["grads"], f64["grads"], label).values()) \
                > TOL_MODEL_F32:
            ref["float64"] = f64
        ref["s"] = time.perf_counter() - t0
        refs[label] = ref
    torch.save(refs, path)


def start_multitask_refs(root: Path) -> tuple:
    """``multitask_reference`` in a process of its own (MULTITASK_CPU_THREADS
    torch threads). Returns (process, log, path)."""
    path = root / "multitask_refs.pt"
    log = open(root / "multitask_refs.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.multitask_reference(sys.argv[1])",
         str(path)], cwd=Path(__file__).resolve().parent, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, path


def finish_multitask_refs(started: tuple, timeout: float = 600) -> dict:
    proc, log, path = started
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        log.close()
    if rc != 0:
        print(Path(log.name).read_text()[-4000:])
        fail(f"the CPU's multitask references exited {rc}")
    return torch.load(path, weights_only=False)


def stop_multitask_refs(started: tuple) -> None:
    proc, log, _ = started
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


def tensor_gaps(got: dict, ref: dict, what: str) -> dict:
    """max|d| / max(1, max|ref|) of each tensor, by name; the key sets equal."""
    if set(got) != set(ref):
        fail(f"{what}: {sorted(set(got) ^ set(ref))} on one device only")
    return {k: (got[k].double() - r.double()).abs().max().item()
            / max(1.0, r.abs().max().item()) for k, r in ref.items()}


def step_gaps_all(got: dict, ref: dict, label: str) -> dict:
    """The largest gap of each part of ``multitask_step``'s record."""
    gaps = {"loss": abs(got["loss"] - ref["loss"]) / max(1.0, abs(ref["loss"]))}
    for part in ("served", "outputs", "grads", "stats"):
        g = tensor_gaps(got[part], ref[part], f"{label} {part}")
        gaps[part] = max(g.values(), default=0.0)
        gaps[f"{part}_worst"] = max(g, key=g.get, default=None)
    return gaps


def multitask_checks(refs: dict) -> dict:
    """Each of MULTITASK_CHECKS on the card against the CPU's reference
    (``multitask_reference``), float32 with TF32 off: every served output,
    the training step's outputs and loss, every gradient and AirNet's
    updated running statistics within TOL_MODEL_F32 x max(1, max|ref|);
    AdaIR's frequency boxes first, equal on both devices; the card's bf16
    ``enhanced`` from its float32 within FAMILY_FACTOR x the CPU's own bf16
    gap on the same weights and input. Where the float32
    gradients part further (rounding: AirNet's gathers sum their backward
    in another order on the card), ``FAMILY_FLOAT64``'s rule: the whole
    step in float64 on both devices (the CPU's from the references where
    its own float32 parted, else here) within TOL_MODEL_F32,
    and the card's float32 gradients within FAMILY_FACTOR x the CPU's own
    float32 gap of the CPU's float64."""
    rows = {}
    with tf32_off():
        for name, kw in MULTITASK_CHECKS:
            label = multitask_label(name, kw)
            ref = refs[label]
            card = build_model(name, seed=MULTITASK_SEED, **kw)
            if not kw and card.param_count() != MULTITASK_PARAMS[name]:
                fail(f"{name} has {card.param_count()} params, not {MULTITASK_PARAMS[name]}")
            batch = {k: v.cuda() for k, v in ref["batch"].items()}
            row = {"seed": ref["seed"], "cpu_s": ref["s"]}
            if ref["products"] is not None:
                boxes = frequency_products(card, batch["image"])
                row["boxes"] = {k: v["box"] for k, v in boxes.items()}
                want = {k: v["box"] for k, v in ref["products"].items()}
                print(f"  {label}: frequency boxes (h_, w_) card {row['boxes']}, CPU {want}")
                if row["boxes"] != want:
                    fail(f"{label}: a frequency box differs between the card and the CPU")
            got = multitask_step(card, batch)
            gaps = step_gaps_all(got, ref["float32"], label)
            bounds = {k: TOL_MODEL_F32 for k in ("loss", "served", "outputs", "grads", "stats")}
            # bf16 serving on the same weights and input as the CPU's bf16
            gaps["bf16"] = multitask_bf16_gap(card, batch)
            bounds["bf16"] = FAMILY_FACTOR * ref["bf16_gap"]
            if gaps["grads"] > TOL_MODEL_F32:
                batch64 = {k: v.double() for k, v in ref["batch"].items()}
                cpu64 = ref.get("float64") or multitask_step(build_model(
                    name, device="cpu", seed=MULTITASK_SEED, dtype=torch.float64, **kw), batch64)
                card64 = multitask_step(build_model(name, seed=MULTITASK_SEED,
                                                    dtype=torch.float64, **kw),
                                        {k: v.cuda() for k, v in batch64.items()})
                gaps["float32_grads"] = gaps["grads"]
                gaps["grads"] = max(tensor_gaps(got["grads"], cpu64["grads"], label).values())
                gaps["cpu_float32_grads"] = max(tensor_gaps(ref["float32"]["grads"],
                                                            cpu64["grads"], label).values())
                bounds["grads"] = max(TOL_MODEL_F32, FAMILY_FACTOR * gaps["cpu_float32_grads"])
                gaps["float64"] = max(v for k, v in step_gaps_all(card64, cpu64, label).items()
                                      if not k.endswith("_worst"))
                bounds["float64"] = TOL_MODEL_F32
                del cpu64, card64
            print(f"  {label} card vs CPU at 1x{MULTITASK_CHECK_HW}^2 (float32, TF32 off): "
                  f"loss {got['loss']:.6f} / {ref['float32']['loss']:.6f}, gaps {gaps} "
                  f"(bounds {bounds})")
            if not all(gaps[k] <= b for k, b in bounds.items()):
                fail(f"{label}: the card disagrees with the CPU: {gaps}")
            rows[label] = {**row, "gaps": gaps, "bounds": bounds}
            del card, got
            torch.cuda.empty_cache()
    return rows


def bench_multitask(model, dtype, name: str, profile: bool) -> tuple:
    """``model`` at MULTITASK_SERVE through a ``Predictor`` (TF32 off): a
    warm-up, then 2 timed batches, or 1 where the warm-up took over 1 s;
    peak memory; with ``profile`` one batch under torch.profiler without
    the host's op events (device ms, and the idle share of the timed
    batch), the timed one itself where there is one (the profiler's cost,
    ~2,000 launches a batch, is under 1% of a second). Returns the row and
    the warm-up's outputs on the host."""
    pred = Predictor(model, bf16=dtype == torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 0.9, MULTITASK_SERVE).astype(
        np.float32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    out = pred.infer({"image": x})
    check_out(out, MULTITASK_SERVE, unit=False)
    first = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
    n = 1 if out["time"] > 1.0 else 2
    del out
    gc.collect()
    times = []

    def timed():
        t0 = time.perf_counter()
        pred.infer({"image": x})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    label = f"{name}_{str(dtype)[6:]}"
    if profile and n == 1:
        _, _, device_ms = profiled(timed, label, ops=False)
    else:
        for _ in range(n):
            timed()
        if profile:
            _, _, device_ms = profiled(lambda: pred.infer({"image": x}), label, ops=False)
    dt = sum(times) / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    b, h, w = MULTITASK_SERVE[:3]
    row = {"ms_per_batch": dt * 1e3, "mp_per_s": b * h * w / 1e6 / dt, "batches": n,
           "peak_gib": peak}
    if profile:
        row.update(device_ms=device_ms, idle_share=max(0.0, 1.0 - device_ms / (dt * 1e3)))
    print(f"  {name} {'x'.join(map(str, MULTITASK_SERVE[:3]))} {str(dtype)[6:]}: "
          f"{row['mp_per_s']:.3f} MP/s, {dt * 1e3:.1f} ms a batch (host clock over {n}), peak "
          f"{peak:.2f} GiB" + (f"; device {row['device_ms']:.1f} ms, idle share "
                               f"{row['idle_share']:.3f}" if profile else ""))
    return row, first


def multitask_serving(name: str, smi: str) -> dict:
    """The model at its published width served at MULTITASK_SERVE in bf16
    and float32 (TF32 off); bf16's ``enhanced`` within
    TOL_MULTITASK_BF16_MEAN x max(1, max|ref|) of float32's on the mean |d|,
    finite, its max |d| reported."""
    model = build_model(name, seed=MULTITASK_SEED)
    rows, outs = {}, {}
    with tf32_off():
        for dtype in (torch.bfloat16, torch.float32):
            gc.collect()
            torch.cuda.empty_cache()
            rows[str(dtype)[6:]], outs[dtype] = bench_multitask(
                model, dtype, name, profile=dtype == torch.bfloat16)
    ref = outs[torch.float32]["enhanced"]
    d = (outs[torch.bfloat16]["enhanced"] - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    rows["bfloat16"]["vs_float32"] = {"max_abs": d.max().item(), "mean_abs": d.mean().item(),
                                      "max_abs_ref": ref.abs().max().item()}
    print(f"  {name} bf16 vs float32 serving: max|d|={d.max().item():.4e}, mean|d|="
          f"{d.mean().item():.4e} (tol {TOL_MULTITASK_BF16_MEAN * scale:.4e}), max|ref|="
          f"{ref.abs().max().item():.4f}; {smi}")
    if not d.mean().item() <= TOL_MULTITASK_BF16_MEAN * scale:
        fail(f"{name}'s bf16 serving disagrees with its float32 serving")
    del model
    return rows


def multitask_train(name: str, smi: str) -> dict:
    """MULTITASK_TRAIN_STEPS Adam steps at the model's batch and crop,
    float32 with torch's default TF32 flags (AirNet on its batch's
    statistics, which the steps must move): ms a step (host clock,
    synchronised, the first with cuDNN's search), the losses finite, peak
    memory; then one step profiled without the host's op events."""
    from enhax_torch.nn.optim import build_optimizer
    from enhax_torch.train import Trainer
    b, hw = MULTITASK_TRAIN[name]
    model = build_model(name, seed=MULTITASK_SEED)
    batch = {k: v.cuda() for k, v in multitask_batch(name, 1, b, hw).items()}
    tr = Trainer(model, build_optimizer({"optimizer": {"name": "adam", "lr": 2e-4}}))
    state = tr.init_state()
    before = [t.clone() for t in model.module.buffers() if t.is_floating_point()]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    with default_tf32():
        for _ in range(MULTITASK_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(tr._train_step(state, batch)["loss"].item())
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, _, device_ms = profiled(lambda: tr._train_step(state, batch), f"train_{name}",
                                   ops=False)
    if not all(np.isfinite(losses)):
        fail(f"{name}: a train step's loss is not finite: {losses}")
    after = [t for t in model.module.buffers() if t.is_floating_point()]
    if any(torch.equal(x, y) for x, y in zip(before, after)):
        fail(f"{name}: a float32 train step left a BatchNorm's statistics as they were")
    print(f"  {name} {b}x{hw}x{hw}, {MULTITASK_TRAIN_STEPS} Adam steps (float32, default TF32 "
          f"flags): losses {losses}, {' / '.join(f'{t * 1e3:.1f}' for t in times)} ms, a "
          f"profiled step's device time {device_ms:.1f} ms, peak {peak:.2f} GiB; {smi}")
    del model, state, tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": [b, hw, hw], "losses": losses, "step_ms": [t * 1e3 for t in times],
            "device_ms": device_ms, "peak_gib": peak}


def phase_multitask(smi: str, refs: dict) -> dict:
    """Slice 20, no kernel of the port (the JAX package computes these
    models, the DCN's gathers and AdaIR's FFTs in XLA): MPRNet, AirNet and
    AdaIR at their published widths on the card against the CPU
    (``multitask_checks``, on ``multitask_reference``'s results from a
    process started before the build); each served at MULTITASK_SERVE in
    bf16 and float32 (``multitask_serving``) and trained
    MULTITASK_TRAIN_STEPS steps at its papers' crop (``multitask_train``).
    Kernel counts reset before and read after: none may launch."""
    t0 = time.perf_counter()
    reset_counts()
    print("[multitask] the card against the CPU, float32, TF32 off")
    checks = multitask_checks(refs)
    rows = {}
    for name in MULTITASK:
        print(f"[multitask] {name}: served, trained")
        gc.collect()
        rows[name] = {"serve": multitask_serving(name, smi), "train": multitask_train(name, smi)}
    if any(counts().values()):
        fail(f"a multitask model launched a kernel of the port: {counts()}")
    phase_s = time.perf_counter() - t0
    print(f"  phase {phase_s:.1f} s")
    return {"checks": checks, "models": rows, "phase_s": phase_s}


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
    xd = rand(gen, DCE_APPLY, 0, 0.3, bf)
    rd = rand(gen, DCE_APPLY[:3] + (24,), -1, 1, bf)
    # (kernel, args, kwargs, bytes, elementwise f32 flops, matmul flops);
    # DCE: interpolation (~12) plus 3 per iteration an element, or 3 per
    # iteration. K1 a pixel: LayerNorm ~7C, taps 36C, gate C; 1x1 4C^2.
    # K2: ~13C elementwise; 1x1s 10C^2 (SCA on the TLC mean of every pixel,
    # conv3, conv4 C->2C, conv5). Their matmul operands are bf16.
    cases = [
        ("fused_curve_upsample_apply", (x, r), {"num_iters": 8, "scale": 8},
         nbytes_of(x, r, x), x.numel() * (12 + 3 * 8), 0),
        ("fused_curve_apply", (xd, rd), {"num_iters": 8, "shared": False},
         nbytes_of(xd, rd, xd), xd.numel() * 3 * 8, 0),
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
        # row 2's per-iteration case: both designs under both methods, bf16
        # on the case above and float32; the kernels line keeps the
        # wrapper's time from the loop above
        apply_turns(xd, rd, False, res["fused_curve_apply"]["bound_ms"])
        xr32 = rand(g32, DCE_APPLY, 0, 0.3, torch.float32)
        rr32 = rand(g32, DCE_APPLY[:3] + (24,), -1, 1, torch.float32)
        apply_turns(xr32, rr32, False, bound(nbytes_of(xr32, rr32, xr32), xr32.numel() * 3 * 8)[0])
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


def host_us(fn, n: int = 50) -> float:
    """Host time of one call of ``fn`` (microseconds, the host's clock):
    ``n`` calls queued from an idle card with no sync between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def apply_turns(x: torch.Tensor, r: torch.Tensor, shared: bool, bound_ms: float) -> dict:
    """``fused_curve_apply`` with 8 iterations, both designs under both
    methods, each in 5 alternating turns (median and range):

    - ``wrapper``: 8 calls by CUDA events, a fresh output each call, as
      ``phase_timing`` times every kernel: where a call's host time exceeds
      the kernel's it sets the pace. ``fused_curve_apply`` itself (the path
      ``apply_path`` names), and each path through ``_apply_launch`` with a
      fresh output (the first design's is its own wrapper's work less the
      checks and the counts);
    - ``queued``: 20 launches into one output, which keep the queue full
      (the device's time): the "vec" path, the first design, the plain
      version and, beside a shared curve, ``torch.add(x, r, out=o)``,
      which moves the same bytes (two reads and one write of the image's
      shape) but is not the same function: the bandwidth yardstick, which
      the port never calls;
    - ``host_us``: the host's time a call (``host_us``) of the wrapper, of
      each path's launch with a fresh output, and of ``apply_path`` alone.
    """
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), r.data_ptr(), out.data_ptr())
    taken = dce_curve.apply_path(x.shape, x.dtype, shared, ptrs, 8)
    fresh = {"fused_curve_apply": lambda: dce_curve.fused_curve_apply(x, r, 8, shared),
             "vec": lambda: dce_curve._apply_launch(x, r, 8, shared, "vec"),
             "general": lambda: dce_curve._apply_launch(x, r, 8, shared, "general")}
    queued = {"vec": lambda: dce_curve._apply_launch(x, r, 8, shared, "vec", out),
              "general": lambda: dce_curve._apply_launch(x, r, 8, shared, "general", out),
              "plain": lambda: dce_curve.fused_curve_apply_plain(x, r, 8, shared)}
    if shared:
        queued["add"] = lambda: torch.add(x, r, out=out)
    host = {**fresh, "apply_path": lambda: dce_curve.apply_path(x.shape, x.dtype, shared,
                                                                  ptrs, 8)}
    with torch.inference_mode():
        times = {"wrapper": {k: spread(v) for k, v in turns(fresh, iters=8, reps=5).items()},
                 "queued": {k: spread(v) for k, v in turns(queued, iters=20, reps=5).items()}}
        host_times = {k: [] for k in host}
        for rep in range(5):
            for k in (list(host) if rep % 2 == 0 else list(reversed(host))):
                host_times[k].append(host_us(host[k]))
    times["host_us"] = {k: spread(v, "us") for k, v in host_times.items()}
    form = "shared" if shared else f"{r.shape[-1]} curves"
    head = f"  fused_curve_apply {tuple(x.shape)} {form} {str(x.dtype)[6:]}"
    for method, label in (("wrapper", "8 calls, a fresh output each"),
                          ("queued", "20 launches into one output")):
        for k, v in times[method].items():
            name = "add (same bytes, not the same function)" if k == "add" else k
            print(f"{head}, {label}, {name}: {v['ms']:.4f} ms ({v['ms_min']:.4f}-"
                  f"{v['ms_max']:.4f}), {bound_ms / v['ms']:.1%} of the {bound_ms:.4f} ms bound")
    print(f"{head}, host time a call: " + ", ".join(
        f"{k} {v['us']:.1f} us ({v['us_min']:.1f}-{v['us_max']:.1f})"
        for k, v in times["host_us"].items()))
    q = times["queued"]
    ratios = f"queued general / vec {q['general']['ms'] / q['vec']['ms']:.3f}"
    if shared:
        ratios += f", vec / add {q['vec']['ms'] / q['add']['ms']:.3f}"
    print(f"  {ratios}; the wrapper takes {taken!r}")
    print(json.dumps({"apply_turns": {"shape": list(x.shape), "curves": r.shape[-1],
                                      "dtype": str(x.dtype), "path": taken,
                                      "bound_ms": bound_ms, **times}}))
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
    # phase_quality's instance chains on the CPU (fits that read nothing of
    # the card's), beside the build and the checks against the CPU, and
    # waited for before the first timed phase
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cpu_chains_") as tmp:
        t0 = time.perf_counter()
        cpu_parts = start_cpu_instance_chains(Path(tmp))
        mt_started = start_multitask_refs(Path(tmp))
        try:
            phase_build()
            errs = phase_kernels(gen)
            elapsed("build and kernel checks")
            phase_model_vs_cpu(gen)
            # correctness checks on the CPU and the card, while the CPU's
            # chains finish (they would be waited for otherwise)
            t_checks = time.perf_counter()
            zr_checks = zero_restore_checks(np.random.default_rng(26))
            t1 = time.perf_counter()
            checks_s = t1 - t_checks
            cpu_instance = finish_cpu_instance_chains(cpu_parts, Path(tmp))
            t_refs = time.perf_counter()
            mt_refs = finish_multitask_refs(mt_started)
            refs_wait_s = time.perf_counter() - t_refs
        finally:
            stop(cpu_parts)
            stop_multitask_refs(mt_started)
    chains_wait_s = time.perf_counter() - t1
    print(f"[quality] the instance chains on the CPU ({QUALITY_CPU_THREADS} threads a part, "
          f"started before the build): {time.perf_counter() - t0:.1f} s, "
          f"{chains_wait_s:.1f} s of it waited for, after Zero-Restore's checks "
          f"({checks_s:.1f} s)")
    elapsed("the CPU's instance chains")
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
        elapsed("uformer")
        gc.collect()
        families = phase_llie_families(np.random.default_rng(22), smi)
        elapsed("low-light families")
        gc.collect()
        zero_ref = phase_llie_zero_ref(np.random.default_rng(23), smi)
        elapsed("zero-reference models")
        gc.collect()
        zero_restore = phase_zero_restore(np.random.default_rng(24), smi, zr_checks)
        metric = phase_metric_cli(np.random.default_rng(25), smi)
        elapsed("Zero-Restore and the metric CLI")
        gc.collect()
        multitask = phase_multitask(smi, mt_refs)
        del mt_refs
    # the clock: what this slice's phases added, and what dropping the
    # instance models' second timed request saved (each repeated the one
    # request still timed, so that request's seconds are the saving)
    saved = sum(r["request_s"][0] for r in instance_models["models"].values()
                if r["request_s"][0] < 10.0)
    profiles = instance["timing"]["profiled_s"] + sum(
        r["profiled_s"] for phase in (instance_models, zero_restore)
        for r in phase["models"].values())
    print(f"[clock] added by Zero-Restore's and the metric CLI's phases: "
          f"{zero_restore['phase_s'] + metric['phase_s']:.1f} s (Zero-Restore "
          f"{zero_restore['phase_s']:.1f} s, the metric CLI {metric['phase_s']:.1f} s), and "
          f"Zero-Restore's checks against the CPU, {checks_s:.1f} s, inside what was the wait "
          f"for the CPU's instance chains (they then waited {chains_wait_s:.1f} s more); saved by "
          f"timing one request of each instance model (each second request repeated the "
          f"first, under 10 s): {saved:.1f} s; the instance models' and Zero-Restore's ten "
          f"profiled requests, without the host's op events: {profiles:.1f} s in all "
          f"(with them key_averages alone took 6.0-6.2 s a 10-step profile on an H100, 1.9 s "
          f"without)")
    for k in NAF:
        launches[k] += train["launches"][k]
    for k in DCE:
        launches[k] += train_more["launches"][k] + instance["launches"][k]
    for k in RST:
        launches[k] += train_rst["launches"][k]
    launches[DCE[1]] += zero_ref["launches"][DCE[1]]
    errs[DCE[1]] = max(errs[DCE[1]], train_more["errs"][DCE[1]], instance["errs"][DCE[1]],
                       zero_ref["errs"][DCE[1]])
    train["timing"]["hinet_zero_dce"] = train_more["timing"]
    train["timing"]["restormer"] = train_rst["timing"]
    print(f"[clock] added by the multitask phase: {multitask['phase_s']:.1f} s; its CPU "
          f"references (a process of {MULTITASK_CPU_THREADS} threads started before the "
          f"build) waited for {refs_wait_s:.1f} s after the instance chains")
    elapsed("multitask models")
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
        quality = phase_quality(smi, cpu_instance)
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
    print(json.dumps({"llie_families": families}))
    print(json.dumps({"llie_zero_ref": zero_ref}))
    print(json.dumps({"zero_restore": zero_restore}))
    print(json.dumps({"metric_cli": metric}))
    print(json.dumps({"multitask": multitask}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
