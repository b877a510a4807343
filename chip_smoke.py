"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python chip_smoke.py``.
It needs one CUDA card, nvcc and the ``enhax_torch`` package beside it; it
imports nothing of JAX or of the ``enhax`` package. Phases:

  1. the card's name and power limit (nvidia-smi), CUDA and torch versions;
  2. build every kernel source under ``enhax_torch/kernels/csrc`` (one nvcc
     per source, all at once);
  3. each kernel against its plain PyTorch version on the card: ragged
     shapes and the main path's shapes. The DCE curve kernels: float32
     (max|d| <= 1e-5) and bfloat16 (<= 1 uint8 LSB after x255, round,
     clip). The NAFBlock kernels K1 and K2: max|d| <= 1e-5 (float32) or
     2^-6 (bfloat16, two bf16 steps) times max(1, max|ref|), and in float32
     the first and last rows and columns no worse than twice the interior;
  4. each model on the card against the same weights on the CPU, float32
     with TF32 off: zero_dce++_re (scale_factor=8) and zero_dce_re,
     max|d| <= 1e-4; nafnet_local at full width, beta and gamma drawn,
     max|d| <= 1e-4 * max(1, max|ref|);
  5. the main paths, serving: a bf16 ``Predictor`` per model answers a few
     requests. Launch counts are reset just before each path and read just
     after it; every NAFNet forward launches K1 and K2 8 times each;
  6. the bench shapes: ``bench.py``'s 48x1088x1920 uint8 chunks (sf=8,
     bf16, uint8 out) and NAFNet-TLC at 2x736x1280 (``bench_all.py`` 3b) in
     bf16 and float32; throughput and peak memory, then one batch under
     torch.profiler (device time by operator);
  7. each kernel's time by CUDA events at the main path's shapes, against
     its bound and its plain version's time.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failed check raises, so the exit code is not 0 and no result
line is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from enhax_torch.infer import Predictor  # noqa: E402
from enhax_torch.kernels import _build, dce_curve, nafblock  # noqa: E402
from enhax_torch.models.base import build_model  # noqa: E402

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
}
DCE = ("fused_curve_upsample_apply", "fused_curve_apply")
NAF = ("k1_apply", "k2_apply")


def fail(msg: str):
    raise RuntimeError(msg)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def counts() -> dict:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def to_u8(x: torch.Tensor) -> torch.Tensor:
    return (x.float() * 255.0).round().clamp(0, 255).to(torch.uint8)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand(gen: np.random.Generator, shape, lo: float, hi: float, dtype) -> torch.Tensor:
    a = gen.uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def compare(name: str, args: tuple, kwargs: dict) -> float:
    """Run the kernel and its plain version on the same card inputs; return
    max|d| in float32 and check it against the dtype's tolerance."""
    k = KERNELS[name]
    with torch.inference_mode():
        out = k["wrapper"](*args, **kwargs)
        ref = k["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"{name}: bad output {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    shape = tuple(args[0].shape)
    if name in NAF:
        ok = check_rel(name, out, ref)
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
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")


def phase_kernels(gen) -> dict:
    """Kernel vs plain version; returns max|d| at the main path's shapes."""
    print("[kernels] kernel vs plain version on the card")
    up, ap = "fused_curve_upsample_apply", "fused_curve_apply"
    for dtype in (torch.float32, torch.bfloat16):
        for shape, s in (((2, 36, 52, 3), 4), ((2, 40, 72, 3), 8)):
            n, h, w, c = shape
            x = rand(gen, shape, 0, 1, dtype)
            r = rand(gen, (n, h // s, w // s, c), -1, 1, dtype)
            compare(up, (x, r), {"num_iters": 8, "scale": s})
        x = rand(gen, (2, 37, 53, 3), 0, 1, dtype)
        for shared, rc in ((False, 24), (True, 3)):
            r = rand(gen, (2, 37, 53, rc), -1, 1, dtype)
            compare(ap, (x, r), {"num_iters": 8, "shared": shared})
    # the main path's shapes: zero_dce++ at sf=8 on 48 frames of 1088x1920,
    # zero_dce_re on one 1080p frame (padded to 1088x1920), both bfloat16
    errs = {}
    x = rand(gen, (48, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    r = rand(gen, (48, 136, 240, 3), -1, 1, torch.bfloat16)
    errs[up] = compare(up, (x, r), {"num_iters": 8, "scale": 8})
    x = rand(gen, (1, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    r = rand(gen, (1, 1088, 1920, 24), -1, 1, torch.bfloat16)
    errs[ap] = compare(ap, (x, r), {"num_iters": 8, "shared": False})
    # the NAFBlock kernels: ragged shapes (H, W not multiples of K1's 14x30
    # tile, one-row images), then the main path's, where K2 takes the TLC
    # local mean of K1's output
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 17, 37, 8), (1, 1, 45, 16), (3, 29, 61, 32), (1, 15, 31, 64),
                      (2, 1, 7, 64)):
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


def check_out(out: dict, shape: tuple, unit: bool = True) -> None:
    y = out["enhanced"]
    if tuple(y.shape) != shape:
        fail(f"output {tuple(y.shape)}, expected {shape}")
    if not torch.isfinite(y).all():
        fail("output not finite")
    if unit and (y.min() < 0 or y.max() > 1):
        fail("output outside [0, 1]")


def phase_serve(gen) -> dict:
    """The main path: Predictors answering requests. Returns launch counts."""
    print("[serve] bf16 Predictors answering requests")
    pp = Predictor(build_model("zero_dce++_re", scale_factor=8.0), bf16=True)
    pr = Predictor(build_model("zero_dce_re"), bf16=True)
    frame = gen.uniform(0, 0.3, (1080, 1920, 3)).astype(np.float32)
    frames = [gen.uniform(0, 0.3, (720, 1280, 3)).astype(np.float32) for _ in range(4)]
    odd = gen.uniform(0, 0.3, (601, 803, 3)).astype(np.float32)
    pp.infer({"image": frame})  # first request: cuDNN picks its algorithms
    torch.cuda.synchronize()
    reset_counts()
    t = {}
    out = pp.infer({"image": frame})
    check_out(out, (1, 1080, 1920, 3))
    t["zero_dce++_re 1080x1920"] = out["time"]
    batches = list(pp.predict_iter(({"image": f} for f in frames), batch_size=4))
    if len(batches) != 1:
        fail(f"predict_iter made {len(batches)} batches of 4 same-shaped frames")
    check_out(batches[0][0], (4, 720, 1280, 3))
    t["zero_dce++_re 4x720x1280"] = batches[0][0]["time"]
    out = pp.infer({"image": odd})
    check_out(out, (1, 601, 803, 3))
    t["zero_dce++_re 601x803"] = out["time"]
    out = pr.infer({"image": frame})
    check_out(out, (1, 1080, 1920, 3))
    t["zero_dce_re 1080x1920"] = out["time"]
    torch.cuda.synchronize()
    c = counts()
    for k, v in t.items():
        print(f"  {k}: {v * 1e3:.3f} ms (host clock, synchronised)")
    print(f"  launches: {c}")
    if min(c[k] for k in DCE) < 1:
        fail(f"a kernel of the path was not launched while serving: {c}")
    return {k: c[k] for k in DCE}


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
    print(f"  {mps:.2f} MP/s, {dt * 1e3:.3f} ms per chunk (host clock over "
          f"{n_chunks} chunks), peak memory {peak / 2**30:.3f} GiB")
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
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        model.apply({"image": x})
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=60,
                                      max_name_column_width=70)
    PROFILES.mkdir(parents=True, exist_ok=True)
    (PROFILES / f"profile_nafnet_{name}.txt").write_text(table)
    print("\n".join(table.splitlines()[:22] + table.splitlines()[-3:]))
    return {"mp_per_s": mps, "ms_per_batch": dt * 1e3, "peak_bytes": peak}


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


def phase_timing(gen) -> dict:
    """Kernel and plain-version times by CUDA events at the main path's
    shapes, in turns (plain, kernel, kernel, plain). Bytes count each input
    (params included) read once and the output written once. Returns the
    first case of each kernel (the one the kernels line reports)."""
    print("[timing] CUDA events, main-path shapes, bfloat16")
    bf = torch.bfloat16
    x = rand(gen, (48, 1088, 1920, 3), 0, 0.3, bf)
    r = rand(gen, (48, 136, 240, 3), -1, 1, bf)
    xr = rand(gen, (1, 1088, 1920, 3), 0, 0.3, bf)
    rr = rand(gen, (1, 1088, 1920, 24), -1, 1, bf)
    # (kernel, args, kwargs, bytes, elementwise f32 flops, matmul flops);
    # DCE: interpolation (~12) plus 3 per iteration an element, or 3 per
    # iteration. K1 a pixel: LayerNorm ~7C, taps 36C, gate C; 1x1 4C^2.
    # K2: ~13C elementwise; 1x1s 10C^2. Their matmul operands are bf16.
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
            print(f"  {name} {tuple(args[0].shape)}: kernel {k1:.4f} / {k2:.4f} ms, "
                  f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e9:.4f} GB; all flops at the f32 rate {f32_ms:.4f} ms), "
                  f"{b_ms / ms:.1%} of the bound")
            res.setdefault(name, {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                  "bound_by": b_by})
    return res


def main() -> None:
    smi, kind = phase_device()
    gen = np.random.default_rng(0)
    phase_build()
    errs = phase_kernels(gen)
    phase_model_vs_cpu(gen)
    launches = {**phase_serve(gen), **phase_serve_nafnet(gen)}
    bench = {"zero_dce++_re 48x1088x1920 bfloat16": phase_bench()}
    for dtype in (torch.bfloat16, torch.float32):
        bench[f"nafnet_local 2x736x1280 {str(dtype)[6:]}"] = phase_bench_nafnet(dtype)
    timing = phase_timing(gen)
    kernels = []
    for name, k in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k["source"],
                        "replaces": k["replaces"], "launches": launches[name],
                        "max_abs_err": errs[name], **timing[name],
                        "library_ms": None})
    print(json.dumps({"bench": bench}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
