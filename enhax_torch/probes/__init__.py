"""Probes of the port's kernels on the card, the counterparts of the JAX
package's ``run/probe_*.py``:

    python -m enhax_torch.probes.dw_mxu        # R1/R2 with the dw 3x3 folded, A/B
    python -m enhax_torch.probes.dw_roofline   # the dw 3x3 alone against its bound
    python -m enhax_torch.probes.gelu_kernel   # the two erf forms, and R2

Each times its variants with CUDA events, interleaved in one process, and
prints the card's name and power limit and then one JSON line a case. A
probe needs a CUDA card and raises without one.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from enhax_torch.models.base import resolve_device

# H100 SXM, NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_device() -> torch.device:
    """The card a probe times on (raises where there is none)."""
    return resolve_device("cuda")


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


def turns(fns: dict, iters: int, reps: int) -> dict:
    """``reps`` turns over ``fns`` (name to a call), the order reversed every
    other turn, each call timed by ``cuda_ms`` over ``iters``: the times of
    each name, one a turn."""
    times = {name: [] for name in fns}
    for rep in range(reps):
        order = list(fns) if rep % 2 == 0 else list(reversed(fns))
        for name in order:
            times[name].append(cuda_ms(fns[name], iters))
    return times


def spread(times: list, key: str = "ms") -> dict:
    """The median, least and largest of ``times`` as ``key``, ``key_min``,
    ``key_max``."""
    return {key: float(np.median(times)), f"{key}_min": min(times), f"{key}_max": max(times)}


def uniform(seed: int, shape, lo: float, hi: float, dtype, device) -> torch.Tensor:
    """numpy's uniform draw from ``seed``, on ``device`` in ``dtype``."""
    a = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.from_numpy(a).to(device, dtype)


def arg(argv, name: str, default: str) -> str:
    """The value after ``--name`` in ``argv``, as the JAX probes read theirs."""
    flag = f"--{name}"
    return argv[argv.index(flag) + 1] if flag in argv else default
