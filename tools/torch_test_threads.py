"""How torch's thread pool behaves when pytest's workers share one host's
cores: COPIES concurrent runs of one pytest selection, each with the same
environment overrides, and the wall time of all of them.

    python tools/torch_test_threads.py \
        "tests/test_torch_uformer.py::test_forward_loss_and_gradients_match_jax" \
        --copies 6 [--env OMP_NUM_THREADS=1] [--env XLA_FLAGS=...] [--timeout 1200]

Prints one line: the overrides, the wall time, and each copy's exit code and
pytest summary line (a copy cut by --timeout exits 124).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser("torch-test-threads")
    p.add_argument("selection")
    p.add_argument("--copies", type=int, default=6)
    p.add_argument("--env", action="append", default=[], help="NAME=VALUE, repeatable")
    p.add_argument("--timeout", type=float, default=1200)
    a = p.parse_args(argv)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **dict(e.split("=", 1) for e in a.env)}
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", a.selection]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(a.copies)]
    results = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(1.0, a.timeout - (time.perf_counter() - t0)))
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            rc = 124
        tail = [line for line in out.splitlines() if " in " in line and ("passed" in line or "failed" in line)]
        results.append((rc, tail[-1] if tail else ""))
    print(f"env {a.env or ['(defaults)']}: {a.copies} copies in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"rc {rc} {summary}" for rc, summary in results))


if __name__ == "__main__":
    main()
