"""The ASPP decoder (NCHW) of the v2 model on ResNet50-OS8, a frozen copy
of the port's `models/aspp.py::ASPP(in_channels=2048, skip_lo_ch=256)`:
the lyltc1/ZebraPose fork's `ASPP_50` (`zebrapose/model/aspp.py:117-
225`).

`aspp.py::ASPP`'s trunk and forward, fed 2048 channels: the dilated
branches (1x1, 3x3 d6/d12/d18) and the global-pool branch each take
2048 -> 256, the 1x1 fuse 1280 -> 256, then `upsample_1`, the concat of
the 256-channel `x_64` skip, `upsample_2` (512 -> 256), the concat of
the 64-channel `x_128` skip and the output conv (320 -> `num_classes`)
at h/2. Module names follow the port's state-dict keys.

Departures from the fork's code: BatchNorm as in `resnet50.py`.
"""

from __future__ import annotations

from torch import nn

from benchmark.reference.aspp import _BRANCHES, ASPP, UpsampleBlock
from benchmark.reference.layers import TorchBatchNorm, TorchConv

IN_CHANNELS = 2048      # x_high
SKIP_LO = 256           # x_64, concatenated before upsample_2
SKIP_HI = 64            # x_128, concatenated before conv_1x1_4


class ASPP50(nn.Module):
    """(x_high, x_128, x_64) -> [N, num_classes, h/2, w/2] logits.
    `quant` (every trunk conv's int8 mode) leaves the transposed convs
    and the output conv float, as the port does."""

    def __init__(self, num_classes: int, concat: bool = True,
                 output_kernel_size: int = 1, quant=False):
        super().__init__()
        self.concat = concat
        for name, k, pad, dil in _BRANCHES:
            setattr(self, name, TorchConv(IN_CHANNELS, 256, k, 1, pad, dil,
                                          quant=quant))
            setattr(self, "bn_" + name, TorchBatchNorm(256))
        self.conv_1x1_2 = TorchConv(IN_CHANNELS, 256, 1, quant=quant)
        self.bn_conv_1x1_2 = TorchBatchNorm(256)
        self.conv_1x1_3 = TorchConv(256 * (len(_BRANCHES) + 1), 256, 1,
                                    quant=quant)
        self.bn_conv_1x1_3 = TorchBatchNorm(256)
        self.upsample_1 = UpsampleBlock(256, 256, quant)
        self.upsample_2 = UpsampleBlock(256, 256 + SKIP_LO if concat
                                        else 256, quant)
        k = output_kernel_size
        self.conv_1x1_4 = TorchConv(256 + SKIP_HI, num_classes, k, 1,
                                    1 if k == 3 else 0)

    # the same wiring as the 512-channel decoder's
    forward = ASPP.forward
