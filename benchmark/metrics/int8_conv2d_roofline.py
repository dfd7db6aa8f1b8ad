"""The int8 convolution kernels' share of their roofline, %: the summed
bound over one forward's quantized convs (operations at the int8 peak
or bytes at the memory rate, each conv its larger) over the kernels'
device time per forward from the profiler, by kernel name."""

from benchmark import flops
from benchmark.metrics._common import peaks, per_unit_kernel_s, quantized, share_pct


def read(run):
    convs = quantized(run)
    if not convs:
        return None
    least = sum(flops.int8_conv_least_seconds(c, peaks(run)) for c in convs)
    return share_pct(least, per_unit_kernel_s(
        run, ["wgmma_conv_kernel", "gather_conv_kernel"]))
