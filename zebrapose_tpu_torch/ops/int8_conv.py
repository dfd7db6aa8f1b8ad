"""int8 serving convolution: CUDA kernels + their plain PyTorch versions.

The JAX package's int8 layer (`zebrapose_tpu/models/layers.py::
_Int8Conv`) quantizes the activation per tensor, hands the int8 operands
to XLA's convolution with int32 accumulation and dequantizes the sum.
PyTorch has no CUDA int8 convolution, so the port computes the two
halves with kernels of its own (`csrc/int8_conv.cu`, CUDA C++ for
sm_90a; the source note gives the design and what bounds each):

  * `quantize_act(x)`: x NHWC (bf16 or f32) -> (xq int8 NHWC, sx [1] f32)
    with sx = max(amax|x|, 1e-8) / 127 and xq = clamp(round(x / sx),
    -127, 127), round half to even. sx stays on the device.
  * `int8_conv2d(xq, wq, sx, sw, bias, stride, padding, dilation,
    out_dtype)`: xq [N, H, W, Cin] int8, wq [Cout, kh, kw, Cin] int8 ->
    y [N, Ho, Wo, Cout] = float(acc) * (sx * sw) (+ bias) in f32, then
    `out_dtype` (f32 or bf16), acc the int32 sum of the convolution with
    zero padding; square stride, padding and dilation.

Both are `torch.library` ops (`zebrapose::quantize_act`,
`zebrapose::int8_conv2d`, no argument mutated): the CUDA implementation
launches the kernel through ctypes and counts the launch on the wrapper
(`quantize_act.launches`, `int8_conv2d.launches`), the CPU
implementation is the plain version, and the Meta implementation gives
the shapes, so `torch.export` traces an int8 model with one node per
call. Importing this module registers the ops; a process that loads an
exported int8 program imports it first (`eval/export_serving.py`).

The plain convolution sums in float64 (`F.conv2d` on the integer
values): every partial sum stays below 2^53, so it is exact and equals
the int32 accumulator of JAX and of the kernel; the epilogue then
rounds in the same order as both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    """A convolution's output extent along one axis."""
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as IEEE division on every device. PyTorch's CUDA division
    by a Python scalar multiplies by the scalar's reciprocal, which can
    differ from JAX's (and the kernels') quotient in the last bit; a
    0-d tensor on t's device divides."""
    return t / t.new_full((), 127.0)


def quantize_act_reference(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `quantize_act`."""
    xf = x.float()
    sx = div127(torch.clamp_min(xf.abs().amax(), 1e-8))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx.reshape(1)


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                    padding: int, dilation: int) -> torch.Tensor:
    """The int32 accumulator of the convolution, NCHW [N, Cout, Ho, Wo],
    from xq NHWC and wq [Cout, kh, kw, Cin]: a float64 convolution of the
    integer values, exact (module docstring)."""
    return F.conv2d(xq.permute(0, 3, 1, 2).double(),
                    wq.permute(0, 3, 1, 2).double(), None, stride, padding,
                    dilation).to(torch.int32)


def int8_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor,
                          sx: torch.Tensor, sw: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int,
                          padding: int, dilation: int,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `int8_conv2d` (NHWC in, NHWC out)."""
    acc = int8_accumulate(xq, wq, stride, padding, dilation)
    y = acc.float() * (sx * sw)[None, :, None, None]
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1).contiguous()


def _lib():
    from zebrapose_tpu_torch.ops import _build

    lib = _build.load("int8_conv")
    if lib.zp_int8_conv2d.argtypes is None:
        lib.zp_quantize_act.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.zp_quantize_act.restype = ctypes.c_int
        lib.zp_int8_conv2d.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 13 + [ctypes.c_void_p]
        lib.zp_int8_conv2d.restype = ctypes.c_int
    return lib


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _quantize_act_cuda(x: torch.Tensor):
    """The op's CUDA implementation: one launch of the quantizer (its
    max pass and its quantizing pass)."""
    if x.dtype not in _KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(f"quantize_act takes a contiguous f32 or bf16 "
                         f"tensor, not {x.dtype} with strides {x.stride()}")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    sx = torch.empty(1, dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().zp_quantize_act(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                x.numel(), scratch.data_ptr(),
                                sx.data_ptr(), xq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"zp_quantize_act launch failed: CUDA error {rc}")
    quantize_act.launches += 1
    return xq, sx


def _quantize_act_meta(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((1,), dtype=torch.float32))


def _conv_shapes(xq, wq, stride, padding, dilation):
    n, h, w, c = xq.shape
    cout, kh, kw, cin = wq.shape
    if cin != c:
        raise ValueError(f"wq takes {cin} channels, xq has {c}")
    return (n, out_size(h, kh, stride, padding, dilation),
            out_size(w, kw, stride, padding, dilation), cout)


def _int8_conv2d_cuda(xq, wq, sx, sw, bias, stride, padding, dilation,
                      out_dtype):
    """The op's CUDA implementation: one launch of the implicit-GEMM
    convolution."""
    for name, t, dtype in (("xq", xq, torch.int8), ("wq", wq, torch.int8),
                           ("sx", sx, torch.float32),
                           ("sw", sw, torch.float32),
                           ("bias", bias, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, not {xq.device}")
    if out_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"int8_conv2d writes f32 or bf16, not {out_dtype}")
    n, h, w, c = xq.shape
    cout, kh, kw, _ = wq.shape
    shape = _conv_shapes(xq, wq, stride, padding, dilation)
    if sx.numel() != 1 or sw.shape != (cout,) or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError("sx must hold one scale, sw and bias one a "
                         "channel")
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = _lib().zp_int8_conv2d(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), n, h, w, c, cout, kh, kw, stride,
        padding, dilation, shape[1], shape[2], stream)
    if rc != 0:
        raise RuntimeError(f"zp_int8_conv2d launch failed: CUDA error {rc}")
    int8_conv2d.launches += 1
    return out


def _int8_conv2d_meta(xq, wq, sx, sw, bias, stride, padding, dilation,
                      out_dtype):
    return xq.new_empty(_conv_shapes(xq, wq, stride, padding, dilation),
                        dtype=out_dtype)


# a Library fragment, as in ops/pnp_kernel.py (the custom_op decorator
# inspects its caller's module at registration)
_OPS = torch.library.Library("zebrapose", "FRAGMENT")
_OPS.define("quantize_act(Tensor x) -> (Tensor, Tensor)")
_OPS.define("int8_conv2d(Tensor xq, Tensor wq, Tensor sx, Tensor sw, "
            "Tensor? bias, int stride, int padding, int dilation, "
            "ScalarType out_dtype) -> Tensor")
_OPS.impl("quantize_act", _quantize_act_cuda, "CUDA")
_OPS.impl("quantize_act", quantize_act_reference, "CPU")
_OPS.impl("quantize_act", _quantize_act_meta, "Meta")
_OPS.impl("int8_conv2d", _int8_conv2d_cuda, "CUDA")
_OPS.impl("int8_conv2d", int8_conv2d_reference, "CPU")
_OPS.impl("int8_conv2d", _int8_conv2d_meta, "Meta")


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization of an NHWC activation:
    (xq int8, sx [1] f32). The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_device(x)
    return torch.ops.zebrapose.quantize_act(x.contiguous())


quantize_act.launches = 0


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
                padding: int, dilation: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 convolution with its dequantizing epilogue, NHWC in and
    out (module docstring). The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_device(xq)
    _conv_shapes(xq, wq, stride, padding, dilation)
    return torch.ops.zebrapose.int8_conv2d(
        xq, wq, sx, sw, bias, int(stride), int(padding), int(dilation),
        out_dtype)


int8_conv2d.launches = 0


def occupancy() -> dict:
    """The convolution kernel's resources as the CUDA runtime reports
    them (see `ops/pnp_kernel.py::occupancy`)."""
    fn = _lib().zp_int8_conv2d_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"zp_int8_conv2d_occupancy: CUDA error {rc}")
    return dict(zip(("blocks_per_sm", "threads_per_block",
                     "smem_per_block", "registers", "local_bytes"), out))
