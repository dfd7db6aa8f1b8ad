"""ZebraPoseNet: ResNet-OS8 backbone + ASPP decoder(s) + head split.

Port of `zebrapose_tpu/models/zebra_net.py`, every family of it:
  * "v1": mask + code;
  * "v2": mask + entire_mask + code from one decoder (the fork's trained
    model);
  * "v3": mask + code from the main decoder, entire_mask from a second,
    mask-conditioned decoder (`aspp_v3`);
  * base > 2 (the non-binary ablations): split mask / code heads with
    `binary_code_length * base` CE code channels;
on ResNet34, or (v1 / v2, base 2) ResNet50. v3 or base > 2 on ResNet50
raises NotImplementedError, as in the JAX package: the reference wires
them for the 34-layer backbone only.

The public layout is the JAX one: NHWC input, NHWC logits in a dict
("mask", "entire_mask" for v2 / v3, "code"). Inside, the network runs
NCHW; an NHWC input tensor permuted to NCHW is channels-last in memory,
which cuDNN takes as is when the weights are channels-last too. Module
names follow the reference checkpoints (`net.resnet...`, `net.aspp...`,
`net.aspp_v3...`), so `models/convert.py::variables_to_state_dict`
output loads strictly.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from zebrapose_tpu_torch.models.aspp import ASPP, ASPPNonBinary, ASPPv3
from zebrapose_tpu_torch.models.resnet import ResNet34OS8, ResNet50OS8

_HEADS = {"v1": 1, "v2": 2, "v3": 1}


class _Net(nn.Module):
    def __init__(self, code_length: int, base: int, variant: str,
                 resnet_layers: int, concat: bool, output_kernel_size: int,
                 quant=False):
        super().__init__()
        self.variant, self.base = variant, base
        if resnet_layers == 34:
            self.resnet = ResNet34OS8(quant)
            in_ch, skip_lo = 512, 64
        else:
            self.resnet = ResNet50OS8(quant)
            in_ch, skip_lo = 2048, 256     # x_high and x_64 widths
        if base != 2:
            self.aspp = ASPPNonBinary(code_length, base, concat=concat,
                                      output_kernel_size=output_kernel_size,
                                      quant=quant)
            return
        self.aspp = ASPP(code_length + _HEADS[variant], concat=concat,
                         output_kernel_size=output_kernel_size,
                         in_channels=in_ch, skip_lo_ch=skip_lo, quant=quant)
        if variant == "v3":
            self.aspp_v3 = ASPPv3(1, output_kernel_size=output_kernel_size,
                                  quant=quant)

    def forward(self, x):
        x_high, x_128, x_64, _, _ = self.resnet(x)
        out = self.aspp(x_high, x_128, x_64)
        if self.variant != "v3" or self.base != 2:
            return out
        return out, self.aspp_v3(out[:, :1], x_high, x_128, x_64)


class ZebraPoseNet(nn.Module):
    """Encoder-decoder predicting the visible mask, (v2 / v3) the entire
    mask, and the code planes (`binary_code_length` of them, or
    `binary_code_length` groups of `base` CE logits for base > 2).

    quant: the convs' int8 mode, with unchanged parameters (JAX's
    `quant`): False; True, int8 serving (inference only); "qat", the
    differentiable int8 simulation for quantization-aware training. The
    gate, the heads and the transposed convs stay as in JAX
    (`models/layers.py`)."""

    def __init__(self, binary_code_length: int = 16, base: int = 2,
                 variant: str = "v2", resnet_layers: int = 34,
                 concat: bool = True, output_kernel_size: int = 1,
                 quant=False):
        super().__init__()
        if variant not in _HEADS:
            raise ValueError(f"variant {variant!r}: v1, v2 or v3")
        if resnet_layers not in (34, 50):
            raise NotImplementedError(f"resnet_layers={resnet_layers}")
        if resnet_layers != 34 and (variant == "v3" or base != 2):
            # the reference wires the v3 second decoder and the
            # non-binary ablation head for the 34-layer backbone only
            raise NotImplementedError(
                "v3 / non-binary variants require resnet_layers=34")
        self.variant, self.base, self.quant = variant, base, quant
        self.net = _Net(binary_code_length, base, variant, resnet_layers,
                        concat, output_kernel_size, quant)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [N, H, W, 3] -> logits {"mask" [N,H/2,W/2,1], ("entire_mask"
        [N,H/2,W/2,1],) "code" [N,H/2,W/2,n]}."""
        out = self.net(x.permute(0, 3, 1, 2))
        if self.base != 2:
            mask, code = out
            return {"mask": mask.permute(0, 2, 3, 1),
                    "code": code.permute(0, 2, 3, 1)}
        if self.variant == "v3":
            out, entire = out
            out = out.permute(0, 2, 3, 1)
            return {"mask": out[..., :1],
                    "entire_mask": entire.permute(0, 2, 3, 1),
                    "code": out[..., 1:]}
        out = out.permute(0, 2, 3, 1)
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
