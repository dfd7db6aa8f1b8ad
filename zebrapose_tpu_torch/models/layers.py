"""Primitive layers, torch side of `zebrapose_tpu/models/layers.py`.

The JAX package pins PyTorch's conv padding, BatchNorm and
transposed-conv semantics in flax; here they are the torch modules
themselves (cuDNN on the card). The classes keep the JAX argument order
so the two model definitions read alike. The int8 and QAT convs are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class TorchConv(nn.Conv2d):
    """nn.Conv2d(in, features, k, stride, padding, dilation)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__(in_features, features, kernel_size, stride, padding,
                         dilation, bias=use_bias)


class TorchConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d(in, features, k, stride, padding,
    output_padding)."""

    def __init__(self, features: int, in_features: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = False):
        super().__init__(in_features, features, kernel_size, stride, padding,
                         output_padding, bias=use_bias)


class TorchBatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d with eps 1e-5 and momentum 0.1 (flax 0.9)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(3, stride=2, padding=1) on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


def interpolate_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on NHWC."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
