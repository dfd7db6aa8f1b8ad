"""The whole training step's share of the card's peak, %: three times
one forward's conv FLOPs at the batch (forward, and the backward's two
products), at the bf16 peak, over the measured time per step in the
profiled span."""

from benchmark import flops
from benchmark.metrics._common import peaks, share_pct


def read(run):
    prof = run.get("profile")
    if not prof or not run.get("conv_layers"):
        return None
    least = 3 * flops.forward_flops(run["conv_layers"]) / \
        peaks(run)["bf16_flops_per_s"]
    return share_pct(least, prof["window_s"] / prof["batches"])
