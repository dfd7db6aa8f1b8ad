"""The reference network of the family v2 on ResNet34-OS8, base 2: the
frozen `reference/zebra_net.py::ZebraPoseNet`.

Found by `harness.reference_network` from a configuration's `network`
group, as `nets/<variant>_r<resnet_layers>_base<base>.py`, and loaded
by path: imports are absolute.
"""

from __future__ import annotations

from torch import nn

from benchmark.reference.zebra_net import ZebraPoseNet


def build(net: dict, quant: bool = False) -> nn.Module:
    """NHWC input, NHWC logits {"mask", "entire_mask", "code"}; `quant`:
    the convs' int8 serving arithmetic."""
    return ZebraPoseNet(binary_code_length=net["code_bits"],
                        concat=net["concat_encoder_decoder"],
                        output_kernel_size=net["output_kernel_size"],
                        quant=quant)
