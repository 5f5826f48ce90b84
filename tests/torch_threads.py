"""Torch's intra-op threads, capped for the port's tests under xdist.

Each xdist worker would otherwise start one torch thread per core beside
the other workers, and the port's small CPU ops then spend their time
waiting on one another. Imported by every ``tests/test_torch_*.py``
module (each worker imports them all when it collects), it gives each
worker its share of the cores: ``cpu_count // workers``, at least 1. A
run without xdist keeps torch's default."""

import os

import torch

#: torch's own default, before any cap
DEFAULT = torch.get_num_threads()


def cap_threads():
    """Set torch's intra-op threads to this worker's share of the cores;
    returns the count in force."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


cap_threads()
