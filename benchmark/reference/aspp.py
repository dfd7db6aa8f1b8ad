"""The DeepLabV3-style ASPP decoder (NCHW) of the v2 model, a frozen
copy of the port's `models/aspp.py::ASPP` on the ResNet34 backbone.

Dilated branches (1x1, 3x3 d6/d12/d18) and a global-pool branch -> 1x1
fuse -> two transposed-conv upsample stages with skip concats (x_64,
x_128) -> output conv at h/2 with `num_classes` channels. Module names
follow the reference state-dict keys (`conv_1x1_1` beside
`bn_conv_1x1_1`, `upsample_1.{0,1,3,4,6,7}`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import TorchBatchNorm, TorchConv, TorchConvTranspose


def _conv_bn_relu(conv: nn.Module, bn: nn.Module, x):
    return F.relu(bn(conv(x)))


class UpsampleBlock(nn.Sequential):
    """ConvT(s2) + BN + ReLU + 2 x (Conv3x3 + BN + ReLU)."""

    def __init__(self, features: int, in_features: int, quant=False):
        super().__init__(
            TorchConvTranspose(features, in_features, 3, 2, 1, 1),
            TorchBatchNorm(features), nn.ReLU(),
            TorchConv(features, features, 3, 1, 1, use_bias=False,
                      quant=quant),
            TorchBatchNorm(features), nn.ReLU(),
            TorchConv(features, features, 3, 1, 1, use_bias=False,
                      quant=quant),
            TorchBatchNorm(features), nn.ReLU())


_BRANCHES = (("conv_1x1_1", 1, 0, 1), ("conv_3x3_1", 3, 6, 6),
             ("conv_3x3_2", 3, 12, 12), ("conv_3x3_3", 3, 18, 18))


class ASPP(nn.Module):
    """(x_high, x_128, x_64) -> [N, num_classes, h/2, w/2] logits.
    `quant` (every trunk conv's int8 mode) leaves the transposed convs
    and the output conv float, as the port does."""

    def __init__(self, num_classes: int, concat: bool = True,
                 output_kernel_size: int = 1, quant=False):
        super().__init__()
        self.concat = concat
        for name, k, pad, dil in _BRANCHES:
            setattr(self, name, TorchConv(512, 256, k, 1, pad, dil,
                                          quant=quant))
            setattr(self, "bn_" + name, TorchBatchNorm(256))
        self.conv_1x1_2 = TorchConv(512, 256, 1, quant=quant)
        self.bn_conv_1x1_2 = TorchBatchNorm(256)
        self.conv_1x1_3 = TorchConv(256 * (len(_BRANCHES) + 1), 256, 1,
                                    quant=quant)
        self.bn_conv_1x1_3 = TorchBatchNorm(256)
        self.upsample_1 = UpsampleBlock(256, 256, quant)
        self.upsample_2 = UpsampleBlock(256, 256 + 64 if concat else 256,
                                        quant)
        k = output_kernel_size
        self.conv_1x1_4 = TorchConv(256 + 64, num_classes, k, 1,
                                    1 if k == 3 else 0)

    def forward(self, x_high, x_128, x_64):
        h, w = x_high.shape[2], x_high.shape[3]
        outs = [_conv_bn_relu(getattr(self, name),
                              getattr(self, "bn_" + name), x_high)
                for name, _, _, _ in _BRANCHES]
        gp = x_high.mean(dim=(2, 3), keepdim=True)
        gp = _conv_bn_relu(self.conv_1x1_2, self.bn_conv_1x1_2, gp)
        outs.append(gp.expand(-1, -1, h, w))
        fused = _conv_bn_relu(self.conv_1x1_3, self.bn_conv_1x1_3,
                              torch.cat(outs, dim=1))
        up1 = self.upsample_1(fused)
        if self.concat:
            up1 = torch.cat([up1, x_64], dim=1)
        feat = torch.cat([self.upsample_2(up1), x_128], dim=1)
        return self.conv_1x1_4(feat)
