"""Serving entry: mean host time per batch, ms, inside the step call
(the upload of the batch's frames and parameters, preprocess and the
issue of every kernel; a call that waits for the device waits here)."""

from benchmark.metrics._common import mean


def read(run):
    xs = run.get("host_issue_s")
    return None if not xs or "profile" not in run else mean(xs) * 1e3
