"""Cap torch's intra-op threads on each pytest-xdist worker.

Every torch worker would otherwise start one intra-op thread a core, so
N workers on C cores run N·C compute threads. Importing this module
(the port's test files do) sets each worker's share, C // N threads
(at least one), from PYTEST_XDIST_WORKER_COUNT and the CPU count. Outside
xdist it changes nothing.
"""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    _cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    torch.set_num_threads(max(1, _cores // _workers))
