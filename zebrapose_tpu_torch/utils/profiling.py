"""The `--profile` hook (a torch.profiler trace of a region) and the
model's parameter and FLOP count.

Port of `zebrapose_tpu/utils/profiling.py` (`profile_trace`,
`model_cost`). Where the JAX package writes a JAX profiler trace, this
writes a Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) of the host and, on a CUDA device, of its kernels.
Where it reads FLOPs off XLA's cost analysis, this counts them with
`torch.utils.flop_counter` (`count_flops`).
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


def count_flops(fn, *args) -> int:
    """FLOPs of `fn(*args)` as `torch.utils.flop_counter.FlopCounterMode`
    counts them: matmuls and convolutions (forward and, if `fn` runs
    one, backward), 2 a multiply-add; elementwise ops count 0, and so do
    ops without a formula, among them the port's custom ops
    (`zebrapose::epnp_minimal_hypotheses`, `zebrapose::quantize_act`,
    `zebrapose::int8_conv2d`). XLA's cost analysis, which the JAX
    package reports, also counts elementwise ops."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def model_cost(model: torch.nn.Module, example_input: torch.Tensor) -> dict:
    """Parameters and FLOPs of one eval forward of `model` on
    `example_input` (the reference's thop harness,
    model/BinaryCodeNet.py:199-205; JAX `utils/profiling.py::
    model_cost`): {"params": the count of the module's parameters (BN
    statistics are buffers, not counted, as JAX counts only `params`),
    "flops": `count_flops` of the forward}. The model is put in eval
    mode."""
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        flops = count_flops(model, example_input)
    return {"params": int(n_params), "flops": float(flops)}
