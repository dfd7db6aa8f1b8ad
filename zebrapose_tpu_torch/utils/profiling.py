"""The `--profile` hook (a torch.profiler trace of a region), the
program's named spans, and the model's parameter and FLOP count.

Port of `zebrapose_tpu/utils/profiling.py` (`profile_trace`,
`model_cost`). Where the JAX package writes a JAX profiler trace, this
writes a Chrome trace (`trace.json`, viewable in Perfetto or
chrome://tracing) of the host and, on a CUDA device, of its kernels.
Where it reads FLOPs off XLA's cost analysis, this counts them with
`torch.utils.flop_counter` (`count_flops`).

`span(name)` marks a stage of the serving and training steps
(`zebrapose.serve.*`, `zebrapose.train.*`), of the pose decode that
they and the fleet share (`zebrapose.decode.*`) and of the run loops
(`zebrapose.run.*`). While a torch profiler records, the stage is a
`record_function` range on the profiler's clock (in `--profile`'s
`trace.json`, and an NVTX range under
`torch.autograd.profiler.emit_nvtx()`), and its host interval is kept
for `spans()`. Otherwise a span costs one check of the profiler's state.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

# (name, thread id, start ns, end ns) of the spans closed while a
# profiler recorded, on time.perf_counter_ns's clock; the oldest drop
# out past maxlen
_SPANS: Deque[Tuple[str, int, int, int]] = collections.deque(maxlen=65536)


@contextlib.contextmanager
def span(name: str, clock: Optional[Dict[str, float]] = None):
    """A named stage. While a torch profiler records, a
    `record_function(name)` range whose host interval is kept for
    `spans()`; otherwise nothing. With `clock`, the stage's host seconds
    are added, either way, to `clock` under the name's last part
    (`zebrapose.run.wait_s` adds to `clock["wait_s"]`)."""
    recording = _profiler_enabled()
    if not recording and clock is None:
        yield
        return
    t0 = time.perf_counter_ns()
    with (torch.autograd.profiler.record_function(name) if recording
          else contextlib.nullcontext()):
        yield
    t1 = time.perf_counter_ns()
    if recording:
        _SPANS.append((name, threading.get_ident(), t0, t1))
    if clock is not None:
        clock[name.rsplit(".", 1)[1]] += (t1 - t0) / 1e9


def spans() -> List[Tuple[str, int, int, int]]:
    """The spans recorded while a profiler recorded, oldest first:
    (name, thread id, start ns, end ns)."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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
