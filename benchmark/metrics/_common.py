"""Helpers the metric readers share. A reader is `read(run) -> float |
None`: `run` is the driver's record of a --trace 1 run; None when the
run holds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

from typing import List, Optional

from benchmark import harness


def mean(xs: Optional[List[float]]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def per_unit_kernel_s(run: dict, needles) -> Optional[float]:
    """Device seconds, per profiled batch or step, of the kernels whose
    names hold one of `needles`; None without a profile or a kernel."""
    prof = run.get("profile")
    if not prof:
        return None
    s = sum(harness.kernel_seconds(prof, n)[0] for n in needles)
    if s <= 0:
        return None
    return s / prof["batches"]


def share_pct(least_s: float, measured_s: Optional[float]
              ) -> Optional[float]:
    if not measured_s:
        return None
    return 100.0 * least_s / measured_s


def peaks(run: dict) -> dict:
    return run["config"]["peaks"]


def quantized(run: dict):
    return [c for c in run.get("conv_layers", []) if c["quantized"]]
