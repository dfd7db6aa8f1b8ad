"""Frozen copy of the port's `models/layers.py` as the v2 network uses
it (the benchmark's plain reference). Changed: the int8 serving conv
computes in `int8.py`'s plain arithmetic with the module's `qmax`, where
the port launches its kernels.

`TorchConv(quant=True)` is the int8 serving conv (`_Int8Conv`), with
the same parameters (`weight`, `bias`) as the plain conv, so one
checkpoint loads into both. Only a conv with Cin·Cout >= 16384 is
quantized; the quantized form computes in float32 whatever the model's
dtype, and its parameters stay float32 when the model is cast
(`TorchConv._apply`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .int8 import div_by, int8_conv2d, quantize_act


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a quantized conv returns: the autocast dtype under
    autocast, else its input's (the JAX layers' `astype(self.dtype)`)."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _weight_scale(w: torch.Tensor, qmax: int = 127) -> torch.Tensor:
    """sw [Cout] = max(amax_c, 1e-8) / qmax of a float32 [Cout, ...]
    weight."""
    return div_by(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8), qmax)


def quantize_weight(weight: torch.Tensor, qmax: int = 127
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a [Cout, Cin, kh, kw]
    weight: (round(w / sw) as float, sw [Cout]), in float32."""
    w = weight.float()
    sw = _weight_scale(w, qmax)
    return torch.round(w / sw[:, None, None, None]), sw


def _int8_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: int, padding: int,
               dilation: int, qmax: int = 127) -> torch.Tensor:
    """`_Int8Conv` on NCHW in the plain arithmetic of `int8.py`: weights
    per channel, the activation per tensor over the whole batch, the
    integer sum, y = float(acc) * (sx * sw) + b in float32, cast to the
    output dtype."""
    out_dtype = _out_dtype(x)
    wq, sw = quantize_weight(weight, qmax)
    xq, sx = quantize_act(x.permute(0, 2, 3, 1), qmax)
    y = int8_conv2d(xq, wq.permute(0, 2, 3, 1), sx, sw,
                    None if bias is None else bias.float(), stride,
                    padding, dilation, out_dtype)
    return y.permute(0, 3, 1, 2)


def _keep_float32(fn):
    """`fn` for Module._apply, except that a float32 tensor stays
    float32: it follows fn's device and memory layout only."""

    def apply(t):
        out = fn(t)
        if t.dtype == torch.float32 and out.is_floating_point() and \
                out.dtype != torch.float32:
            out = torch.empty_like(out, dtype=torch.float32).copy_(t)
        return out

    return apply


class TorchConv(nn.Conv2d):
    """nn.Conv2d(in, features, k, stride, padding, dilation), or with
    `quant` and in·features >= `quant_min_cinxcout`, the int8 serving
    conv (module docstring). Below the gate `quant` is False: the plain
    conv, bit-exact."""

    # the port's gate: quantize only convs wide enough to pay off on the
    # int8 path
    quant_min_cinxcout = 16384
    # the largest code of the quantized arithmetic (7: the int4 control)
    qmax = 127

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True, quant: bool = False):
        super().__init__(in_features, features, kernel_size, stride, padding,
                         dilation, bias=use_bias)
        wide = in_features * features >= self.quant_min_cinxcout
        self.quant = quant if wide else False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        return _int8_conv(x, self.weight, self.bias, self.stride[0],
                          self.padding[0], self.dilation[0], self.qmax)

    def _apply(self, fn, recurse=True):
        # the quantizers read float32 parameters whatever the model's
        # dtype (JAX keeps and quantizes f32 params): a cast of a
        # quantized conv moves its parameters, their dtype stays
        return super()._apply(_keep_float32(fn) if self.quant else fn,
                              recurse)


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
    which the buffer is set. Eval mode is nn.BatchNorm2d's."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
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


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(3, stride=2, padding=1) on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)
