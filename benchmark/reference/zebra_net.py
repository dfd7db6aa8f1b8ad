"""ZebraPoseNet v2 on ResNet34: the ResNet-OS8 backbone, the ASPP
decoder and the head split; a frozen copy of the port's
`models/zebra_net.py` for the family v2 on ResNet34, base 2 (the fork's
trained model), which `nets/v2_r34_base2.py` builds.

The public layout is the port's: NHWC input, NHWC logits in a dict
("mask", "entire_mask", "code"). Inside, the network runs NCHW. Module
names follow the reference checkpoints (`net.resnet...`, `net.aspp...`),
so `convert.py::variables_to_state_dict` output loads strictly.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .aspp import ASPP
from .resnet import ResNet34OS8


class _Net(nn.Module):
    def __init__(self, code_length: int, concat: bool,
                 output_kernel_size: int, quant=False):
        super().__init__()
        self.resnet = ResNet34OS8(quant)
        self.aspp = ASPP(code_length + 2, concat=concat,
                         output_kernel_size=output_kernel_size, quant=quant)

    def forward(self, x):
        x_high, x_128, x_64, _, _ = self.resnet(x)
        return self.aspp(x_high, x_128, x_64)


class ZebraPoseNet(nn.Module):
    """Encoder-decoder predicting the visible mask, the entire mask and
    `binary_code_length` code planes. quant: the convs' int8 serving
    mode (inference only), with unchanged parameters; the gate, the head
    and the transposed convs stay as in the port (`layers.py`)."""

    def __init__(self, binary_code_length: int = 16, concat: bool = True,
                 output_kernel_size: int = 1, quant: bool = False):
        super().__init__()
        self.net = _Net(binary_code_length, concat, output_kernel_size,
                        quant)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [N, H, W, 3] -> logits {"mask" [N,H/2,W/2,1], "entire_mask"
        [N,H/2,W/2,1], "code" [N,H/2,W/2,n]}."""
        out = self.net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
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
