"""torch's thread pool for the port's CPU tests, sized to the test run.

tier-1 runs six pytest workers on one host. Left alone, torch gives each
worker's intra-op pool one thread per core, so the workers' pools together
oversubscribe the cores several times over, and the spinning threads of
small ops starve one another: on 8 cores six concurrent runs of the Uformer
forward/gradient cases had done half their cases after 642 s, where one run
alone takes 65 s and six with one torch thread each 115 s
(``tools/torch_test_threads.py``). A port
test module imports ``capped_torch_threads``; being autouse, it applies to
that module's tests alone: each runs on the cores divided by the workers
(``PYTEST_XDIST_WORKER_COUNT``; all of them in a run without workers), and
the pool is restored after it.
"""

from __future__ import annotations

import os

import pytest
import torch


def thread_share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


@pytest.fixture(autouse=True)
def capped_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, thread_share()))
    yield
    torch.set_num_threads(n)
