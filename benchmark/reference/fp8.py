"""The training control's arithmetic: every convolution of the reference
network computed on float8 operands, the step below bf16 autocast that
Hopper's fp8 tensor cores offer. The forward's activations and weights
are rounded to e4m3 and the backward's output gradients to e5m2, each
under a per-tensor scale from its absmax (the usual fp8 training
recipe); sums, BatchNorm, the losses and Adam stay float32."""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through `dtype` and back, scaled so that its absmax lands on the
    format's largest finite value."""
    top = torch.finfo(dtype).max
    scale = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _ForwardE4M3(torch.autograd.Function):
    """e4m3 rounding of a forward operand; the gradient passes unchanged
    (straight through)."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _BackwardE5M2(torch.autograd.Function):
    """The identity forward; the gradient arriving at a conv's output is
    rounded to e5m2 before the conv's backward uses it."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, E5M2)


def _conv_forward(self, x):
    xq, wq = _ForwardE4M3.apply(x), _ForwardE4M3.apply(self.weight)
    if isinstance(self, nn.ConvTranspose2d):
        y = F.conv_transpose2d(xq, wq, self.bias, self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
    else:
        y = F.conv2d(xq, wq, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
    return _BackwardE5M2.apply(y)


def fp8_convs(model: nn.Module) -> nn.Module:
    """`model` with each Conv2d and ConvTranspose2d computing on fp8
    operands (in place)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.forward = types.MethodType(_conv_forward, m)
    return model
