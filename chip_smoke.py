"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments: ``python chip_smoke.py``.
It needs one CUDA card, nvcc and the ``enhax_torch`` package beside it; it
imports nothing of JAX or of the ``enhax`` package. Phases:

  1. the card's name and power limit (nvidia-smi), CUDA and torch versions;
  2. build every kernel source under ``enhax_torch/kernels/csrc`` (one nvcc
     per source, all at once);
  3. each kernel against its plain PyTorch version on the card: ragged
     shapes and the main path's shapes, float32 (max|d| <= 1e-5) and
     bfloat16 (<= 1 uint8 LSB after x255, round, clip);
  4. zero_dce++_re (scale_factor=8) and zero_dce_re on the card against the
     same weights on the CPU, float32 with TF32 off: max|d| <= 1e-4;
  5. the main path, serving: a bf16 ``Predictor`` per model answers a few
     requests (launch counts are reset just before and read just after);
  6. the bench shape of ``bench.py``: 48x1088x1920 uint8 chunks, sf=8, bf16,
     uint8 out; throughput and peak memory, then one chunk under
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
from enhax_torch.kernels import _build, dce_curve  # noqa: E402
from enhax_torch.models.base import build_model  # noqa: E402

# H100 SXM, NVIDIA's data sheet: HBM rate and the float32 rate outside the
# tensor cores (the kernels do elementwise float32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL_F32 = 1e-5
TOL_MODEL_F32 = 1e-4
TOL_BF16_LSB = 1

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
}


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
    out = k["wrapper"](*args, **kwargs)
    ref = k["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"{name}: bad output {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    shape = tuple(args[0].shape)
    if args[0].dtype == torch.float32:
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
    if min(c.values()) < 1:
        fail(f"a kernel was not launched by the models: {c}")


def check_out(out: dict, shape: tuple) -> None:
    y = out["enhanced"]
    if tuple(y.shape) != shape:
        fail(f"output {tuple(y.shape)}, expected {shape}")
    if not torch.isfinite(y).all() or y.min() < 0 or y.max() > 1:
        fail("output not finite or outside [0, 1]")


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
    if min(c.values()) < 1:
        fail(f"a kernel of the path was not launched while serving: {c}")
    return c


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


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_timing(gen) -> dict:
    """Kernel and plain-version times by CUDA events at the main path's
    shapes, in turns (plain, kernel, kernel, plain)."""
    print("[timing] CUDA events, main-path shapes, bfloat16")
    res = {}
    iters = 8
    x = rand(gen, (48, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    r = rand(gen, (48, 136, 240, 3), -1, 1, torch.bfloat16)
    xr = rand(gen, (1, 1088, 1920, 3), 0, 0.3, torch.bfloat16)
    rr = rand(gen, (1, 1088, 1920, 24), -1, 1, torch.bfloat16)
    cases = {
        # elements of the image; flops per element: interpolation (~12) plus
        # 3 per iteration; the apply kernel: 3 per iteration
        "fused_curve_upsample_apply": ((x, r), {"num_iters": 8, "scale": 8}, 12 + 3 * 8),
        "fused_curve_apply": ((xr, rr), {"num_iters": 8, "shared": False}, 3 * 8),
    }
    with torch.inference_mode():
        for name, (args, kw, flops_per_el) in cases.items():
            k = KERNELS[name]
            nbytes = sum(a.numel() * a.element_size() for a in args) \
                + args[0].numel() * args[0].element_size()
            b_ms, b_by = bound(nbytes, args[0].numel() * flops_per_el)
            p1 = cuda_ms(lambda: k["plain"](*args, **kw), iters=3, warmup=1)
            k1 = cuda_ms(lambda: k["wrapper"](*args, **kw), iters=iters)
            k2 = cuda_ms(lambda: k["wrapper"](*args, **kw), iters=iters)
            p2 = cuda_ms(lambda: k["plain"](*args, **kw), iters=3, warmup=1)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            print(f"  {name} {tuple(args[0].shape)}: kernel {k1:.4f} / {k2:.4f} ms, "
                  f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
                  f"({nbytes / 1e9:.3f} GB), {b_ms / ms:.1%} of the bound")
            res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
    return res


def main() -> None:
    smi, kind = phase_device()
    gen = np.random.default_rng(0)
    phase_build()
    errs = phase_kernels(gen)
    phase_model_vs_cpu(gen)
    launches = phase_serve(gen)
    bench = phase_bench()
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
