"""ZebraPoseNet v1/v2: ResNet34-OS8 backbone + ASPP decoder + head split.

Port of `zebrapose_tpu/models/zebra_net.py`. The public layout is the
JAX one: NHWC input, NHWC logits in a dict ("mask", "entire_mask" for
v2, "code"). Inside, the network runs NCHW; an NHWC input tensor
permuted to NCHW is channels-last in memory, which cuDNN takes as is
when the weights are channels-last too. Module names follow the
reference checkpoints (`net.resnet...`, `net.aspp...`), so
`models/convert.py::variables_to_state_dict` output loads strictly.

v3, ResNet50 and the non-binary (base > 2) heads are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from zebrapose_tpu_torch.models.aspp import ASPP
from zebrapose_tpu_torch.models.resnet import ResNet34OS8

_HEADS = {"v1": 1, "v2": 2}


class _Net(nn.Module):
    def __init__(self, n_out: int, concat: bool, output_kernel_size: int):
        super().__init__()
        self.resnet = ResNet34OS8()
        self.aspp = ASPP(n_out, concat=concat,
                         output_kernel_size=output_kernel_size)

    def forward(self, x):
        x_high, x_128, x_64, _, _ = self.resnet(x)
        return self.aspp(x_high, x_128, x_64)


class ZebraPoseNet(nn.Module):
    """Encoder-decoder predicting the visible mask, (v2) the entire
    mask, and the code planes."""

    def __init__(self, binary_code_length: int = 16, base: int = 2,
                 variant: str = "v2", resnet_layers: int = 34,
                 concat: bool = True, output_kernel_size: int = 1):
        super().__init__()
        if variant not in _HEADS or resnet_layers != 34 or base != 2:
            raise NotImplementedError(
                f"ZebraPoseNet(variant={variant!r}, resnet_layers="
                f"{resnet_layers}, base={base}) is not ported yet (see "
                "ROADMAP.md, queue A); the port has v1/v2, ResNet34, "
                "base 2")
        self.variant = variant
        self.net = _Net(binary_code_length + _HEADS[variant], concat,
                        output_kernel_size)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [N, H, W, 3] -> logits {"mask" [N,H/2,W/2,1], ("entire_mask"
        [N,H/2,W/2,1],) "code" [N,H/2,W/2,n]}."""
        out = self.net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.variant == "v1":
            return {"mask": out[..., :1], "code": out[..., 1:]}
        return {"mask": out[..., :1], "entire_mask": out[..., 1:2],
                "code": out[..., 2:]}


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(rgb01: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float in [0, 1] -> ImageNet-normalized (applied to
    BGR frames as the reference does)."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32,
                        device=rgb01.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32,
                       device=rgb01.device)
    return (rgb01 - mean) / std
