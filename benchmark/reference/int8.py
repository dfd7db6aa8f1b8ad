"""The int8 serving convolution's arithmetic in plain PyTorch: the
benchmark's own statement of what the port's `zebrapose::quantize_act`
and `zebrapose::int8_conv2d` compute (JAX's `_Int8Conv`), with the
largest code `qmax` as a parameter (127: int8; 7: int4, the control of
the int8 configuration).

  sx = max(amax|x|, 1e-8) / qmax per tensor, xq = clip(round(x / sx))
  (round half to even); sw = max(amax_c|w|, 1e-8) / qmax per output
  channel, wq = round(w / sw); y = float(acc) * (sx * sw) + b in float32,
  acc the integer sum of the convolution with zero padding.

`exact=True` sums in float64, where every partial sum of int8 operands
stays below 2^53, so it equals the int32 accumulator; float32 rounds
sums above 2^24 and serves the whole forward."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def div_by(t: torch.Tensor, q: float) -> torch.Tensor:
    """t / q as IEEE division on every device (a 0-d tensor divides;
    CUDA's division by a Python scalar multiplies by its reciprocal)."""
    return t / t.new_full((), float(q))


def div127(t: torch.Tensor) -> torch.Tensor:
    return div_by(t, 127.0)


def quantize_act(x: torch.Tensor, qmax: int = 127
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any layout) -> (integer-valued float32 codes, sx [1])."""
    xf = x.float()
    sx = div_by(torch.clamp_min(xf.abs().amax(), 1e-8), qmax)
    xq = torch.clamp(torch.round(xf / sx), -qmax, qmax)
    return xq, sx.reshape(1)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                padding: int, dilation: int, out_dtype: torch.dtype,
                exact: bool = False) -> torch.Tensor:
    """xq NHWC and wq [Cout, kh, kw, Cin] integer-valued -> y NHWC in
    `out_dtype`."""
    dt = torch.float64 if exact else torch.float32
    acc = F.conv2d(xq.permute(0, 3, 1, 2).to(dt),
                   wq.permute(0, 3, 1, 2).to(dt), None, stride, padding,
                   dilation)
    y = acc.float() * (sx * sw)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1)
