"""DeepLabV3-style ASPP decoders (NCHW), port of
`zebrapose_tpu/models/aspp.py` (`ASPP`, `ASPPNonBinary`, `ASPPv3`).

The trunk: dilated branches (1x1, 3x3 d6/d12/d18) and a global-pool
branch -> 1x1 fuse -> two transposed-conv upsample stages with skip
concats (x_64, x_128) -> output conv at h/2. Module names follow the
reference state-dict keys (`conv_1x1_1` beside `bn_conv_1x1_1`,
`upsample_1.{0,1,3,4,6,7}`, ...).

  * ASPP: the main decoder, `num_classes` channels from `conv_1x1_4`.
  * ASPPNonBinary: the base-d ablation head, split into
    `conv_1x1_4_mask` (1 channel) and `conv_1x1_4_code`
    (code_length * base channels, groups of `base` CE logits).
  * ASPPv3: the v3 model's mask-conditioned entire-mask decoder: no d18
    branch, and the first decoder's mask logits (h/2) resized bilinearly
    and concatenated at h/8 (1025 -> 256), at h/4 (before `upsample_2`)
    and at h/2 (before `conv_1x1_4`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from zebrapose_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
    resize_bilinear,
)


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


class _Trunk(nn.Module):
    """The decoders' shared trunk; `branches` names the dilated branches
    (a prefix of _BRANCHES), `fuse_extra` the channels concatenated
    after them before the 1x1 fuse, `up2_in` upsample_2's input. `quant`
    (every trunk conv's int8 mode) leaves the transposed convs and the
    output convs float, as in JAX."""

    def __init__(self, branches: Sequence[str], in_channels: int,
                 fuse_extra: int, up2_in: int, concat: bool = True,
                 quant=False):
        super().__init__()
        self.concat = concat
        self._branches = tuple(branches)
        for name, k, pad, dil in _BRANCHES:
            if name in self._branches:
                setattr(self, name, TorchConv(in_channels, 256, k, 1, pad,
                                              dil, quant=quant))
                setattr(self, "bn_" + name, TorchBatchNorm(256))
        self.conv_1x1_2 = TorchConv(in_channels, 256, 1, quant=quant)
        self.bn_conv_1x1_2 = TorchBatchNorm(256)
        self.conv_1x1_3 = TorchConv(256 * (len(self._branches) + 1)
                                    + fuse_extra, 256, 1, quant=quant)
        self.bn_conv_1x1_3 = TorchBatchNorm(256)
        self.upsample_1 = UpsampleBlock(256, 256, quant)
        self.upsample_2 = UpsampleBlock(256, up2_in, quant)

    def fused(self, x_high, extra: Sequence[torch.Tensor] = ()):
        """The branches, the global pool and `extra`, fused: [N, 256, h,
        w]."""
        h, w = x_high.shape[2], x_high.shape[3]
        outs = [_conv_bn_relu(getattr(self, name),
                              getattr(self, "bn_" + name), x_high)
                for name in self._branches]
        gp = x_high.mean(dim=(2, 3), keepdim=True)
        gp = _conv_bn_relu(self.conv_1x1_2, self.bn_conv_1x1_2, gp)
        outs.append(gp.expand(-1, -1, h, w))
        return _conv_bn_relu(self.conv_1x1_3, self.bn_conv_1x1_3,
                             torch.cat(outs + list(extra), dim=1))

    def decode(self, x_high, x_128, x_64):
        """[N, 256 + x_128's channels, h/2, w/2]: the features the
        output convs read."""
        up1 = self.upsample_1(self.fused(x_high))
        if self.concat:
            up1 = torch.cat([up1, x_64], dim=1)
        return torch.cat([self.upsample_2(up1), x_128], dim=1)


_ALL = tuple(b[0] for b in _BRANCHES)


class ASPP(_Trunk):
    """The main decoder: (x_high, x_128, x_64) -> [N, num_classes,
    h/2, w/2] logits. ResNet50: in_channels 2048, skip_lo_ch 256."""

    def __init__(self, num_classes: int, concat: bool = True,
                 output_kernel_size: int = 1, in_channels: int = 512,
                 skip_lo_ch: int = 64, skip_hi_ch: int = 64, quant=False):
        super().__init__(_ALL, in_channels, 0,
                         256 + skip_lo_ch if concat else 256, concat, quant)
        k = output_kernel_size
        self.conv_1x1_4 = TorchConv(256 + skip_hi_ch, num_classes, k, 1,
                                    1 if k == 3 else 0)

    def forward(self, x_high, x_128, x_64):
        return self.conv_1x1_4(self.decode(x_high, x_128, x_64))


class ASPPNonBinary(_Trunk):
    """The base-d ablation decoder: (x_high, x_128, x_64) -> (mask
    [N, 1, h/2, w/2], code [N, code_length * base, h/2, w/2]) logits."""

    def __init__(self, code_length: int, base: int, concat: bool = True,
                 output_kernel_size: int = 1, quant=False):
        super().__init__(_ALL, 512, 0, 256 + 64 if concat else 256, concat,
                         quant)
        k = output_kernel_size
        pad = 1 if k == 3 else 0
        self.conv_1x1_4_mask = TorchConv(256 + 64, 1, k, 1, pad)
        self.conv_1x1_4_code = TorchConv(256 + 64, code_length * base, k,
                                         1, pad)

    def forward(self, x_high, x_128, x_64):
        feat = self.decode(x_high, x_128, x_64)
        return self.conv_1x1_4_mask(feat), self.conv_1x1_4_code(feat)


class ASPPv3(_Trunk):
    """The v3 entire-mask decoder: (mask [N, 1, h/2, w/2] logits of the
    first decoder, x_high, x_128, x_64) -> [N, num_classes, h/2, w/2]."""

    def __init__(self, num_classes: int = 1, output_kernel_size: int = 1,
                 quant=False):
        super().__init__(_ALL[:3], 512, 1, 256 + 64 + 1, quant=quant)
        k = output_kernel_size
        self.conv_1x1_4 = TorchConv(256 + 64 + 1, num_classes, k, 1,
                                    1 if k == 3 else 0)

    def forward(self, mask, x_high, x_128, x_64):
        h, w = x_high.shape[2], x_high.shape[3]
        up1 = self.upsample_1(self.fused(x_high,
                                         [resize_bilinear(mask, (h, w))]))
        up1 = torch.cat([up1, x_64, resize_bilinear(mask, (2 * h, 2 * w))],
                        dim=1)
        up2 = torch.cat([self.upsample_2(up1), x_128, mask], dim=1)
        return self.conv_1x1_4(up2)
