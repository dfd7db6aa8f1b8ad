"""The ResNet50 output-stride-8 backbone with decoder skip taps (NCHW),
a frozen copy of the port's `models/resnet.py::Bottleneck` and
`ResNet50OS8`: the lyltc1/ZebraPose fork's `ResNet50_OS8`
(`zebrapose/model/resnet.py:277`), which `resnet_layer = 50` selects.

The torchvision stem, then Bottleneck layer1 (3 blocks, 256 channels
out) and layer2 (4 blocks, 512 out, stride 2) in `resnet` (a Sequential:
0 conv1, 1 bn1, 2 relu, 3 maxpool, 4 layer1, 5 layer2), then the fork's
dilated BasicBlock stages `layer4` (6 blocks, 1024 channels, dilation 2)
and `layer5` (3 blocks, 2048 channels, dilation 4), at stride 8. The
skip-tap Sequentials `resnet_layer_{1,2,3}` are aliases of the stem,
layer1 and layer2 modules, as in `resnet.py`, so the port's state dicts
load strictly.

Departures from the fork's code: the weights are drawn from a seed, not
loaded from torchvision's ImageNet resnet50; BatchNorm's running
variance moves toward the biased batch variance (`layers.py::
TorchBatchNorm`, as the port follows flax), where torch's moves toward
the unbiased one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import TorchBatchNorm, TorchConv
from benchmark.reference.resnet import _MaxPool, _stage


class Bottleneck(nn.Module):
    """torchvision Bottleneck (1x1 -> 3x3 -> 1x1 x4, the stride on the
    3x3); `downsample` is a (conv1x1, bn) Sequential or empty."""

    expansion = 4

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 quant=False):
        super().__init__()
        out_ch = self.expansion * channels
        self.conv1 = TorchConv(in_channels, channels, 1, 1, 0,
                               use_bias=False, quant=quant)
        self.bn1 = TorchBatchNorm(channels)
        self.conv2 = TorchConv(channels, channels, 3, stride, 1, 1,
                               use_bias=False, quant=quant)
        self.bn2 = TorchBatchNorm(channels)
        self.conv3 = TorchConv(channels, out_ch, 1, 1, 0, use_bias=False,
                               quant=quant)
        self.bn3 = TorchBatchNorm(out_ch)
        if stride != 1 or in_channels != out_ch:
            self.downsample = nn.Sequential(
                TorchConv(in_channels, out_ch, 1, stride, 0, 1,
                          use_bias=False, quant=quant),
                TorchBatchNorm(out_ch))
        else:
            self.downsample = nn.Sequential()

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + self.downsample(x))


def _bottleneck_stage(in_channels: int, channels: int, num_blocks: int,
                      stride: int = 1, quant=False) -> nn.Sequential:
    out_ch = channels * Bottleneck.expansion
    blocks = [Bottleneck(in_channels, channels, stride, quant)]
    blocks += [Bottleneck(out_ch, channels, 1, quant)
               for _ in range(num_blocks - 1)]
    return nn.Sequential(*blocks)


class ResNet50OS8(nn.Module):
    """Returns (x_high [2048, h/8], x_128 [64, h/2], x_64 [256, h/4],
    x_32 [512, h/8], x_16 [1024, h/8]). `quant`: every conv's int8 mode
    (`TorchConv`)."""

    def __init__(self, quant=False):
        super().__init__()
        self.resnet = nn.Sequential(
            TorchConv(3, 64, 7, 2, 3, use_bias=False, quant=quant),   # 0
            TorchBatchNorm(64),                                       # 1
            nn.ReLU(),                                                # 2
            _MaxPool(),                                               # 3
            _bottleneck_stage(64, 64, 3, quant=quant),       # 4 = layer1
            _bottleneck_stage(256, 128, 4, stride=2,
                              quant=quant),                  # 5 = layer2
        )
        ch = list(self.resnet.children())
        self.resnet_layer_1 = nn.Sequential(*ch[:3])
        self.resnet_layer_2 = nn.Sequential(*ch[3:5])
        self.resnet_layer_3 = nn.Sequential(*ch[5:6])
        self.layer4 = _stage(512, 1024, 6, dilation=2, quant=quant)
        self.layer5 = _stage(1024, 2048, 3, dilation=4, quant=quant)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x_128 = self.resnet_layer_1(x)
        x_64 = self.resnet_layer_2(x_128)
        x_32 = self.resnet_layer_3(x_64)
        x_16 = self.layer4(x_32)
        return self.layer5(x_16), x_128, x_64, x_32, x_16
