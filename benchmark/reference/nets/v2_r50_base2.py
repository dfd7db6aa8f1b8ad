"""The reference network of the family v2 on ResNet50-OS8, base 2: the
fork's `resnet_layer = 50` model (`config_BOP/lmo/exp_lmo_BOP.txt`),
`resnet50.py::ResNet50OS8` under `aspp50.py::ASPP50`, with the v2 head
split of `zebra_net.py` (visible mask, entire mask, code planes).

Found by `harness.reference_network` from a configuration's `network`
group, as `nets/<variant>_r<resnet_layers>_base<base>.py`, and loaded
by path: imports are absolute. Module names are the port's
(`net.resnet...`, `net.aspp...`), so the port's state dicts load
strictly.
"""

from __future__ import annotations

from torch import nn

from benchmark.reference.aspp50 import ASPP50
from benchmark.reference.resnet50 import ResNet50OS8
from benchmark.reference.zebra_net import ZebraPoseNet, _Net


class _Net50(nn.Module):
    def __init__(self, code_length: int, concat: bool,
                 output_kernel_size: int, quant=False):
        super().__init__()
        self.resnet = ResNet50OS8(quant)
        self.aspp = ASPP50(code_length + 2, concat=concat,
                           output_kernel_size=output_kernel_size,
                           quant=quant)

    # backbone, then decoder: the ResNet34 network's wiring
    forward = _Net.forward


class ZebraPoseNet50(nn.Module):
    """NHWC input [N, H, W, 3] -> NHWC logits {"mask" [N,H/2,W/2,1],
    "entire_mask" [N,H/2,W/2,1], "code" [N,H/2,W/2,n]}."""

    def __init__(self, binary_code_length: int = 16, concat: bool = True,
                 output_kernel_size: int = 1, quant: bool = False):
        super().__init__()
        self.net = _Net50(binary_code_length, concat, output_kernel_size,
                          quant)

    # NCHW inside, the v2 head split: the ResNet34 network's
    forward = ZebraPoseNet.forward


def build(net: dict, quant: bool = False) -> nn.Module:
    """NHWC input, NHWC logits {"mask", "entire_mask", "code"}; `quant`:
    the convs' int8 serving arithmetic."""
    return ZebraPoseNet50(binary_code_length=net["code_bits"],
                          concat=net["concat_encoder_decoder"],
                          output_kernel_size=net["output_kernel_size"],
                          quant=quant)
