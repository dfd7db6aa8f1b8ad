"""ResNet34 output-stride-8 backbone with decoder skip taps (NCHW).

Port of `zebrapose_tpu/models/resnet.py::ResNet34OS8`. Module names
follow the reference checkpoints' state-dict keys: the torchvision stem
and layer1/layer2 live in `resnet` (a Sequential: 0 conv1, 1 bn1,
2 relu, 3 maxpool, 4 layer1, 5 layer2), the dilated stages are
`layer4` (6 blocks, 256 ch, dilation 2) and `layer5` (3 blocks, 512 ch,
dilation 4). The reference registers the stem/layer1/layer2 modules a
second time as skip-tap Sequentials `resnet_layer_{1,2,3}`; they are
kept as aliases of the same modules, so its state dicts load strictly.
ResNet50 is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from zebrapose_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    max_pool_3x3_s2_p1,
)


class BasicBlock(nn.Module):
    """torchvision BasicBlock with dilation; `downsample` is a
    (conv1x1, bn) Sequential or empty."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = TorchConv(in_channels, channels, 3, stride, dilation,
                               dilation, use_bias=False)
        self.bn1 = TorchBatchNorm(channels)
        self.conv2 = TorchConv(channels, channels, 3, 1, dilation, dilation,
                               use_bias=False)
        self.bn2 = TorchBatchNorm(channels)
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                TorchConv(in_channels, channels, 1, stride, 0, 1,
                          use_bias=False),
                TorchBatchNorm(channels))
        else:
            self.downsample = nn.Sequential()

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.downsample(x))


def _stage(in_channels: int, channels: int, num_blocks: int, stride: int = 1,
           dilation: int = 1) -> nn.Sequential:
    blocks = [BasicBlock(in_channels, channels, stride, dilation)]
    blocks += [BasicBlock(channels, channels, 1, dilation)
               for _ in range(num_blocks - 1)]
    return nn.Sequential(*blocks)


class _MaxPool(nn.Module):
    def forward(self, x):
        return max_pool_3x3_s2_p1(x)


class ResNet34OS8(nn.Module):
    """Returns (x_high [512, h/8], x_128 [64, h/2], x_64 [64, h/4],
    x_32 [128, h/8], x_16 [256, h/8])."""

    def __init__(self):
        super().__init__()
        self.resnet = nn.Sequential(
            TorchConv(3, 64, 7, 2, 3, use_bias=False),   # 0
            TorchBatchNorm(64),                          # 1
            nn.ReLU(),                                   # 2
            _MaxPool(),                                  # 3
            _stage(64, 64, 3),                           # 4 = layer1
            _stage(64, 128, 4, stride=2),                # 5 = layer2
        )
        ch = list(self.resnet.children())
        self.resnet_layer_1 = nn.Sequential(*ch[:3])
        self.resnet_layer_2 = nn.Sequential(*ch[3:5])
        self.resnet_layer_3 = nn.Sequential(*ch[5:6])
        self.layer4 = _stage(128, 256, 6, dilation=2)
        self.layer5 = _stage(256, 512, 3, dilation=4)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x_128 = self.resnet_layer_1(x)
        x_64 = self.resnet_layer_2(x_128)
        x_32 = self.resnet_layer_3(x_64)
        x_16 = self.layer4(x_32)
        return self.layer5(x_16), x_128, x_64, x_32, x_16
