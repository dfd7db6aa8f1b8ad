"""The yardstick's operation and byte counts, frozen with the benchmark:
a later change to the program does not change what a roofline or an mfu
counts.

  * conv FLOPs from shapes: each convolution of the network (the
    reference network of the configuration's family, traced on the
    meta device) at 2 a multiply-add over every tap, padded ones
    included, as `torch.utils.flop_counter` counts them (the port's
    `utils/profiling.py::model_cost`; a CPU test ties the two);
  * `epnp_operations`: one minimal-set EPnP solve as the port's kernel
    runs it, copied from `chip_smoke.py:510-527`;
  * the int8 bounds of one quantized conv and of its activation
    quantizer, copied from `chip_smoke.py::_conv_bound_ms` (:3690-3704)
    and `int8_forward_sums` (:3707-3760): operations at the int8 peak,
    bytes at the memory rate, each input byte read once and each output
    byte written once.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark import harness
from benchmark.reference.layers import TorchConv


def conv_layers(config: dict, batch: int) -> List[Dict]:
    """Every convolution of one forward of the configuration's network
    at `batch` crops: shapes, whether it is transposed, and whether the
    configuration quantizes it."""
    crop = int(config["shapes"]["crop_img"])
    int8 = bool(config.get("int8", False))
    with torch.device("meta"):
        model = harness.reference_network(config).eval()
        x = torch.empty((batch, crop, crop, 3))
    layers: List[Dict] = []

    def hook(mod, inp, out):
        n, cin, h, w = inp[0].shape
        layers.append(dict(
            transposed=isinstance(mod, torch.nn.ConvTranspose2d),
            n=n, cin=cin, h=h, w=w, cout=out.shape[1], ho=out.shape[2],
            wo=out.shape[3], k=mod.kernel_size[0], stride=mod.stride[0],
            padding=mod.padding[0], dilation=mod.dilation[0],
            groups=mod.groups, bias=mod.bias is not None,
            quantized=int8 and isinstance(mod, TorchConv) and cin * out.shape[1]
            >= TorchConv.quant_min_cinxcout))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return layers


def conv_flops(layer: Dict) -> int:
    """2 a multiply-add over every tap: the output's pixels (a
    transposed conv: the input's) times Cin / groups times Cout times
    k²."""
    pix = layer["h"] * layer["w"] if layer["transposed"] else \
        layer["ho"] * layer["wo"]
    return (2 * layer["n"] * pix * layer["cout"] * layer["cin"]
            // layer["groups"] * layer["k"] * layer["k"])


def forward_flops(layers: List[Dict]) -> int:
    return sum(conv_flops(c) for c in layers)


def forward_least_seconds(layers: List[Dict], peaks: Dict) -> float:
    """The least time the card could take for the forward's
    convolutions: each at the dense peak of the arithmetic it runs in
    (int8 for a quantized conv, else the configuration's float type)."""
    total = 0.0
    for c in layers:
        peak = peaks["int8_ops_per_s"] if c["quantized"] else \
            peaks["bf16_flops_per_s"]
        total += conv_flops(c) / peak
    return total


def epnp_operations(gn_iters: int) -> int:
    """Float operations of one minimal-set solve as the kernel runs it
    (add, sub, mul, div, sqrt, pow; an FMA counts 2), stage by stage.
    Copied from `chip_smoke.py::epnp_operations` (:510-527)."""
    def solve_ls(k):            # 6-row normal equations + Cholesky
        chol = sum(2 * j + 2 + (k - 1 - j) * (2 * j + 1)
                   for j in range(k)) + 1
        return 11 * k * (k + 1) // 2 + 3 * k - 1 + 11 * k + chol + 2 * k * k
    control = 116
    mtm = 6 * (9 + 10 * 15)
    chol12 = sum(2 * j + 2 + (11 - j) * (2 * j + 1) for j in range(12)) + 1
    subspace = 13 + 156 + chol12 + 4 * 4 * 288 + 4 * 430 + 4 * 300
    l6x10 = 6 * 101
    cases = solve_ls(4) + 9 + solve_ls(3) + 4 + solve_ls(5) + 6
    gn = 3 * gn_iters * (192 + 10 + 120 + solve_ls(4) + 4)
    polar = 45 + 12 * 89
    pose = 3 * (84 + 126 + 6 + 18 + 18 + 153 + polar + 18)
    reproj = 3 * (6 * 32 + 1)
    return control + mtm + subspace + l6x10 + cases + gn + pose + reproj


def epnp_least_seconds(n_solves: int, gn_iters: int, peaks: Dict) -> float:
    """The hypothesis kernel's bound: operations at the float32 peak
    outside the tensor cores (each solve reads 39 floats and writes 12,
    far below the memory bound)."""
    return n_solves * epnp_operations(gn_iters) / peaks["fp32_flops_per_s"]


def int8_conv_least_seconds(layer: Dict, peaks: Dict) -> float:
    """One int8_conv2d: 2 M K Cout operations at the int8 peak, or xq,
    wq, sw (and the bias) read once and the bf16 output written once at
    the memory rate; the larger. Copied from
    `chip_smoke.py::_conv_bound_ms` (:3690-3704)."""
    n, h, w, cin, cout, ks = (layer[k] for k in
                              ("n", "h", "w", "cin", "cout", "k"))
    m = n * layer["ho"] * layer["wo"]
    ops = 2 * m * ks * ks * cin * cout
    nbytes = (n * h * w * cin + cout * ks * ks * cin
              + cout * 4 * (2 if layer["bias"] else 1) + m * cout * 2)
    return max(ops / peaks["int8_ops_per_s"],
               nbytes / peaks["memory_bytes_per_s"])


def quantize_act_least_seconds(layer: Dict, peaks: Dict,
                               in_bytes: int = 2) -> float:
    """One quantize_act over a conv's input: the bf16 input read once,
    the int8 codes written once, the scale written (bytes bound; as in
    `chip_smoke.py::int8_forward_sums`, :3743)."""
    elems = layer["n"] * layer["h"] * layer["w"] * layer["cin"]
    return (elems * (in_bytes + 1) + 4) / peaks["memory_bytes_per_s"]
