"""Cap torch's intra-op threads, and the memory each pytest-xdist worker
keeps, on each worker.

Every torch worker would otherwise start one intra-op thread a core, so
N workers on C cores run N·C compute threads. Importing this module
(the port's test files do) sets each worker's share, C // N threads
(at least one), from PYTEST_XDIST_WORKER_COUNT and the CPU count.

glibc's malloc also keeps what a test freed: past its dynamic mmap
threshold (up to 32 MiB) a freed tensor stays in the heap, so a worker
that ran a full-width network test held ~4.3 GiB of its ~5.5 GiB peak
for the rest of the run, and six such workers together ran the machine
short of memory (tests of whole files failed under the 6-worker run
and passed alone). A fixed 1 MiB mmap threshold returns every large
block to the system when it is freed: the same worker then keeps
~0.8-2 GiB between tests. Outside xdist this module changes nothing.
"""

import ctypes
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    _cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    torch.set_num_threads(max(1, _cores // _workers))
    try:
        _libc = ctypes.CDLL("libc.so.6")
    except OSError:            # not glibc: nothing to tune
        _libc = None
    if _libc is not None:
        _libc.mallopt(-3, 1 << 20)     # M_MMAP_THRESHOLD, fixed
        _libc.mallopt(-1, 1 << 20)     # M_TRIM_THRESHOLD
