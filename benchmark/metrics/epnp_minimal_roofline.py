"""The EPnP hypothesis kernel's share of its roofline, %: the bound of
B x H minimal solves (`flops.epnp_operations` at the float32 peak) over
the kernel's device time per batch from the profiler, by kernel name."""

from benchmark import flops
from benchmark.metrics._common import peaks, per_unit_kernel_s, share_pct


def read(run):
    measured = per_unit_kernel_s(run, ["epnp_minimal_kernel"])
    if measured is None:
        return None
    pnp = run["config"]["pnp"]
    least = flops.epnp_least_seconds(run["batch"] * pnp["n_hypotheses"],
                                     pnp["gn_iters"], peaks(run))
    return share_pct(least, measured)
