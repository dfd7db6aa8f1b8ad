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
    """nn.BatchNorm2d with eps 1e-5 and momentum 0.1 (flax 0.9).

    In training, the running variance follows flax, the port's
    reference: it moves toward the biased batch variance (torch's own
    update uses the unbiased one, n/(n-1) larger). Both normalize the
    batch with the biased variance, so outputs and gradients are
    torch's. The fused kernel updates a copy of the [C] buffer, from
    which the buffer is set. Eval mode is nn.BatchNorm2d's, in plain
    tensor ops under torch.func transforms (`_eval_tensor_ops`)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if torch._C._functorch.is_functorch_wrapped_tensor(x):
                return self._eval_tensor_ops(x)
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # autograd keeps the variance buffer the kernel got: hand it a
        # copy, so the correction below does not touch a saved tensor
        fused = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, fused, self.weight,
                         self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # fused = (1-m) old + m var n/(n-1); flax's term is m var
            keep = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(keep + (fused - keep) * ((n - 1) / n))
        return y

    def _eval_tensor_ops(self, x: torch.Tensor) -> torch.Tensor:
        """Eval mode in plain tensor ops, for the fleet's vmapped forward
        (torch.func): there CUDA's batch_norm asks its input for a
        memory format, which vmap cannot answer. A bf16 activation is
        widened exactly."""
        shape = (1, -1, 1, 1)
        x = x.to(self.running_var.dtype)
        y = (x - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps)
        return y * self.weight.view(shape) + self.bias.view(shape)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(3, stride=2, padding=1) on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) on NCHW; the
    identity at the same size."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def interpolate_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """`resize_bilinear` on NHWC (the JAX package's layout)."""
    return resize_bilinear(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
