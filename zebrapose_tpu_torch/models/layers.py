"""Primitive layers, torch side of `zebrapose_tpu/models/layers.py`.

The JAX package pins PyTorch's conv padding, BatchNorm and
transposed-conv semantics in flax; here they are the torch modules
themselves (cuDNN on the card). The classes keep the JAX argument order
so the two model definitions read alike.

`TorchConv(quant=...)` also takes the JAX layer's int8 modes, with the
same parameters (`weight`, `bias`) in every mode, so one checkpoint
loads into all of them:
  False  -- nn.Conv2d;
  True   -- `_int8_conv`, the int8 serving conv (`_Int8Conv`): the
            quantizer and the convolution are the kernels of
            `ops/int8_conv.py`;
  "qat"  -- `_fake_quant_conv`, its differentiable twin for
            quantization-aware training (`_FakeQuantConv`).
As in JAX, only a conv with Cin·Cout >= 16384 is quantized, both
quantized forms compute in float32 whatever the model's dtype, and
their parameters stay float32 when the model is cast (`TorchConv._apply`):
a bf16 model quantizes the f32 weights, as JAX's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from zebrapose_tpu_torch.ops.int8_conv import (
    div127,
    int8_conv2d,
    quantize_act,
)
from zebrapose_tpu_torch.parallel.mesh import all_reduce_sum


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a quantized conv returns: the autocast dtype under
    autocast, else its input's (the JAX layers' `astype(self.dtype)`)."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def _weight_scale(w: torch.Tensor) -> torch.Tensor:
    """sw [Cout] = max(amax_c, 1e-8) / 127 of a float32 [Cout, ...]
    weight."""
    return div127(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-8))


def quantize_weight(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a [Cout, Cin, kh, kw]
    weight: (round(w / sw) as float, sw [Cout]), in float32."""
    w = weight.float()
    sw = _weight_scale(w)
    return torch.round(w / sw[:, None, None, None]), sw


def _int8_conv(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: int, padding: int,
               dilation: int) -> torch.Tensor:
    """`_Int8Conv` on NCHW: weights per channel, the activation per
    tensor over the whole batch (dynamic), int32 accumulation,
    y = float(acc) * (sx * sw) + b in float32, cast to the output dtype.
    Inference only. An NCHW tensor in channels-last memory is NHWC to
    the kernels without a copy, and the result comes back so."""
    out_dtype = _out_dtype(x)
    wq, sw = quantize_weight(weight)
    wq = wq.to(torch.int8).permute(0, 2, 3, 1).contiguous()
    xq, sx = quantize_act(x.permute(0, 2, 3, 1))
    y = int8_conv2d(xq, wq, sx, sw, None if bias is None else bias.float(),
                    stride, padding, dilation, out_dtype)
    return y.permute(0, 3, 1, 2)


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() whose gradient is the identity (straight-through
    estimator)."""
    return x + (torch.round(x) - x).detach()


def _fake_quant_conv(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], stride: int,
                     padding: int, dilation: int) -> torch.Tensor:
    """`_FakeQuantConv`: the int8 conv's forward in float on
    integer-valued tensors, differentiable. The scales are detached, the
    rounding is the STE, and the clip is spelled min(max(., -127), 127),
    whose gradient at a tie with a bound is 0.5 as `jnp.clip`'s is
    (torch.clamp's is 1); the element at the activation's amax rounds to
    127, so every layer has such a tie. The conv runs in float32 with
    autocast off, as JAX runs it on its f32 operands."""
    out_dtype = _out_dtype(x)
    w = weight.float()
    sw = _weight_scale(w).detach()
    wq = _ste_round(w / sw[:, None, None, None])
    xf = x.float()
    sx = div127(torch.clamp_min(xf.abs().amax(), 1e-8)).detach()
    v = _ste_round(xf / sx)
    xq = torch.minimum(torch.maximum(v, v.new_full((), -127.0)),
                       v.new_full((), 127.0))
    with torch.autocast(x.device.type, enabled=False):
        y = F.conv2d(xq, wq, None, stride, padding, dilation)
    y = y * (sx * sw)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(out_dtype)


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
    `quant` (True: int8 serving, "qat": fake-quant training) and
    in·features >= `quant_min_cinxcout`, its quantized form (module
    docstring). Below the gate `quant` is False: the plain conv,
    bit-exact."""

    # the JAX layer's gate: quantize only convs wide enough to pay off on
    # the int8 path; "qat" simulates exactly the convs served in int8
    quant_min_cinxcout = 16384

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 use_bias: bool = True, quant: Union[bool, str] = False):
        super().__init__(in_features, features, kernel_size, stride, padding,
                         dilation, bias=use_bias)
        if quant not in (False, True, "qat"):
            raise ValueError(f"quant={quant!r}: False, True or 'qat'")
        wide = in_features * features >= self.quant_min_cinxcout
        self.quant = quant if wide else False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        fn = _fake_quant_conv if self.quant == "qat" else _int8_conv
        return fn(x, self.weight, self.bias, self.stride[0], self.padding[0],
                  self.dilation[0])

    def _apply(self, fn, recurse=True):
        # the quantizers read float32 parameters whatever the model's
        # dtype (JAX keeps and quantizes f32 params): a cast of a
        # quantized conv moves its parameters, their dtype stays
        return super()._apply(_keep_float32(fn) if self.quant else fn,
                              recurse)


def quantized_convs(model: nn.Module) -> Dict[str, TorchConv]:
    """The model's quantized convs by module name. An int8 forward
    launches each int8 kernel (the quantizer, the convolution) once a
    quantized conv."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, TorchConv) and m.quant}


def cast_variables(model: nn.Module, variables: Dict[str, torch.Tensor],
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """`variables` (tensors by `model`'s state-dict names, for example
    K models' stacked state) cast to `dtype` as `model.to(dtype)` casts
    the model: floating-point tensors only, and the quantized convs'
    parameters stay float32 (`TorchConv._apply`), under every name the
    state dict gives them (a module registered twice has two)."""
    keep = {f"{n}.{p}"
            for n, m in model.named_modules(remove_duplicate=False)
            if isinstance(m, TorchConv) and m.quant
            for p in ("weight", "bias")}
    return {n: v.to(dtype) if v.is_floating_point() and n not in keep
            else v for n, v in variables.items()}


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
    tensor ops under torch.func transforms (`_eval_tensor_ops`).

    With `world` set to a world of more than one rank
    (`train/state.py::create_train_state` sets it), training takes the
    statistics over the world's batch, as flax's BatchNorm does over a
    GSPMD-sharded batch (`_global_batch`)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.world = None     # parallel.mesh.World of the train state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if torch._C._functorch.is_functorch_wrapped_tensor(x):
                return self._eval_tensor_ops(x)
            return super().forward(x)
        if self.world is not None and self.world.distributed:
            return self._global_batch(x)
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

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the world's batch: each channel's sum and sum
        of squares (in at least float32) and the count, all-reduced with
        autograd (the backward all-reduces their gradients, so every
        rank's gradient holds every rank's share through the
        statistics); flax's variance E[x²] - E[x]², clipped at 0; flax's
        running-variance rule. Not nn.SyncBatchNorm: it all-gathers,
        which gloo cannot do on CUDA tensors, and moves the running
        variance toward the unbiased variance."""
        self.num_batches_tracked.add_(1)
        c = x.shape[1]
        xa = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = all_reduce_sum(torch.cat([
            xa.sum(dim=(0, 2, 3)), (xa * xa).sum(dim=(0, 2, 3)),
            xa.new_full((1,), x.numel() // c)]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(
                m * mean.detach().to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_(
                m * var.detach().to(self.running_var.dtype))
        shape = (1, c, 1, 1)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(var.dtype)
        y = (xa - mean.view(shape)) * scale.view(shape) \
            + self.bias.to(var.dtype).view(shape)
        return y.to(x.dtype)

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
