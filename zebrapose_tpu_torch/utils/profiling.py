"""The `--profile` hook: a torch.profiler trace of a region.

Port of `zebrapose_tpu/utils/profiling.py::profile_trace`. Where the JAX
package writes a JAX profiler trace, this writes a Chrome trace
(`trace.json`, viewable in Perfetto or chrome://tracing) of the host and,
on a CUDA device, of its kernels.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the enclosed region into `<log_dir>/trace.json` when log_dir
    is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
