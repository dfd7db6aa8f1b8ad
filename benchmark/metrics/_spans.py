"""Host time of the program's own stages: the spans that
`zebrapose_tpu_torch.utils.profiling.span` keeps while a torch profiler
records, which in a --trace 1 run is the harness's profiled window.

These are host times under the profiler, which records every ATen op
of the window: a stage that issues many small ops reads longer here
than it takes in an untraced run. They rank a step's stages against
each other in a traced run, not the host time of an untraced one."""

from __future__ import annotations

from typing import Optional

from benchmark import harness


def stage_host_ms(run: dict, step: str, stage: str) -> Optional[float]:
    """Summed host ms of the `stage` spans over the number of `step`
    spans. None without a profile, or where the program records no
    `step` span (a program without spans); a BenchError where it records
    steps but no `stage` span, which every step holds: the span was
    renamed or moved, and its metric would fall silent."""
    if not run.get("profile"):
        return None
    try:
        from zebrapose_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recorded = spans()
    steps = sum(1 for name, *_ in recorded if name == step)
    if not steps:
        return None
    ns = [t1 - t0 for name, _, t0, t1 in recorded if name == stage]
    if not ns:
        raise harness.BenchError(
            f"the program recorded {steps} {step} spans and no {stage}")
    return sum(ns) / steps / 1e6
