"""DeepLabV3-style ASPP decoder (NCHW), port of
`zebrapose_tpu/models/aspp.py::ASPP`.

5 branches (1x1, 3x3 d6/d12/d18, global pool) -> 1x1 fuse -> two
transposed-conv upsample stages with skip concats (x_64, x_128) ->
output conv at h/2. Module names follow the reference state-dict keys
(`conv_1x1_1` beside `bn_conv_1x1_1`, `upsample_1.{0,1,3,4,6,7}`, ...).
The v3 second decoder and the non-binary head are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from zebrapose_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
)


def _conv_bn_relu(conv: nn.Module, bn: nn.Module, x):
    return F.relu(bn(conv(x)))


class UpsampleBlock(nn.Sequential):
    """ConvT(s2) + BN + ReLU + 2 x (Conv3x3 + BN + ReLU)."""

    def __init__(self, features: int, in_features: int):
        super().__init__(
            TorchConvTranspose(features, in_features, 3, 2, 1, 1),
            TorchBatchNorm(features), nn.ReLU(),
            TorchConv(features, features, 3, 1, 1, use_bias=False),
            TorchBatchNorm(features), nn.ReLU(),
            TorchConv(features, features, 3, 1, 1, use_bias=False),
            TorchBatchNorm(features), nn.ReLU())


_BRANCHES = (("conv_1x1_1", 1, 0, 1), ("conv_3x3_1", 3, 6, 6),
             ("conv_3x3_2", 3, 12, 12), ("conv_3x3_3", 3, 18, 18))


class ASPP(nn.Module):
    """The main decoder: (x_high, x_128, x_64) -> [N, num_classes,
    h/2, w/2] logits."""

    def __init__(self, num_classes: int, concat: bool = True,
                 output_kernel_size: int = 1, in_channels: int = 512,
                 skip_lo_ch: int = 64, skip_hi_ch: int = 64):
        super().__init__()
        self.concat = concat
        for name, k, pad, dil in _BRANCHES:
            setattr(self, name, TorchConv(in_channels, 256, k, 1, pad, dil))
            setattr(self, "bn_" + name, TorchBatchNorm(256))
        self.conv_1x1_2 = TorchConv(in_channels, 256, 1)
        self.bn_conv_1x1_2 = TorchBatchNorm(256)
        self.conv_1x1_3 = TorchConv(256 * 5, 256, 1)
        self.bn_conv_1x1_3 = TorchBatchNorm(256)
        self.upsample_1 = UpsampleBlock(256, 256)
        self.upsample_2 = UpsampleBlock(
            256, 256 + skip_lo_ch if concat else 256)
        k = output_kernel_size
        self.conv_1x1_4 = TorchConv(256 + skip_hi_ch, num_classes, k, 1,
                                    1 if k == 3 else 0)

    def forward(self, x_high, x_128, x_64):
        h, w = x_high.shape[2], x_high.shape[3]
        outs = [_conv_bn_relu(getattr(self, name),
                              getattr(self, "bn_" + name), x_high)
                for name, _, _, _ in _BRANCHES]
        gp = x_high.mean(dim=(2, 3), keepdim=True)
        gp = _conv_bn_relu(self.conv_1x1_2, self.bn_conv_1x1_2, gp)
        outs.append(gp.expand(-1, -1, h, w))
        out = _conv_bn_relu(self.conv_1x1_3, self.bn_conv_1x1_3,
                            torch.cat(outs, dim=1))
        up1 = self.upsample_1(out)
        if self.concat:
            up1 = torch.cat([up1, x_64], dim=1)
        up2 = self.upsample_2(up1)
        return self.conv_1x1_4(torch.cat([up2, x_128], dim=1))
