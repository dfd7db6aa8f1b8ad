"""The activation quantizer's share of its roofline, %: the summed bytes
bound over one forward's quantized convs (bf16 input read once, int8
codes and the scale written once) over the quantizer kernels' (absmax
and quantize passes) device time per forward from the profiler."""

from benchmark import flops
from benchmark.metrics._common import peaks, per_unit_kernel_s, quantized, share_pct


def read(run):
    convs = quantized(run)
    if not convs:
        return None
    least = sum(flops.quantize_act_least_seconds(c, peaks(run))
                for c in convs)
    return share_pct(least, per_unit_kernel_s(
        run, ["absmax_kernel", "quantize_kernel"]))
