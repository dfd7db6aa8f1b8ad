"""The whole serving step's share of the card's peak, %: the least time
of one batch's forward (every conv's FLOPs from shapes at the peak of
the arithmetic it runs in) over the measured time per batch in the
profiled span."""

from benchmark import flops
from benchmark.metrics._common import peaks, share_pct


def read(run):
    prof = run.get("profile")
    if not prof or not run.get("conv_layers"):
        return None
    least = flops.forward_least_seconds(run["conv_layers"], peaks(run))
    return share_pct(least, prof["window_s"] / prof["batches"])
