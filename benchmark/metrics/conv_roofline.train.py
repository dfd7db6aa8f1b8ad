"""The training step's convolutions' share of their roofline, %: three
times one forward's conv FLOPs at the batch (the forward, and the
backward's data and weight gradients) at the bf16 peak, over the device
seconds a step in convolution kernels in the profiled window.

A convolution kernel is one whose name holds any of NEEDLES: cuDNN's
fprop, dgrad and wgrad engines, and the implicit-GEMM, cuBLAS (nvjet)
and CUTLASS kernels it picks. Each kernel is counted once, however many
needles its name holds (`xmma_fprop_implicit_gemm` holds two). A kernel
matched that is no convolution only lowers the share."""

from benchmark import flops, harness
from benchmark.metrics._common import peaks, share_pct

NEEDLES = ("fprop", "dgrad", "wgrad", "conv", "gemm", "nvjet", "cutlass")


def conv_kernels(prof: dict) -> dict:
    """{kernel name: device seconds} of the window's convolution
    kernels."""
    return {n: s for n, s in prof["kernel_s"].items()
            if any(k in n for k in NEEDLES)}


def read(run):
    prof = run.get("profile")
    if not prof or not run.get("conv_layers"):
        return None
    seconds = sum(conv_kernels(prof).values())
    if seconds <= 0:
        raise harness.BenchError(
            "the profiled window holds no convolution kernel "
            f"(none of {NEEDLES} in a kernel's name)")
    least = 3 * flops.forward_flops(run["conv_layers"]) / \
        peaks(run)["bf16_flops_per_s"]
    return share_pct(least, seconds / prof["batches"])
