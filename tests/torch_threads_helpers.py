"""One torch thread pool per test worker sized to the worker's share of
the cores, for the port's CPU tests (``tests/test_torch_*.py``). Not a test
module.

The tier-1 command runs the tests in several pytest-xdist worker processes
(``-n 6`` on 8 cores), and each process's torch would use every core for
its intra-op threads: six processes of eight threads contend for eight
cores. Six copies of ``tests/test_torch_remat.py -k "not jax"`` side by
side on this machine took 280 s with torch's default of 8 threads each and
23 s with 1. Each port test module imports the autouse fixture below; in
one process (no xdist) it keeps every core. The thread count changes
where torch splits a CPU reduction, never what a test compares or its
tolerance.
"""

import os

import pytest
import torch


def worker_threads() -> int:
    """The cores divided among the xdist workers (at least 1)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(before)
