"""Minimal-set EPnP for the RANSAC hypothesis stage: CUDA kernel + its
plain PyTorch version.

Replaces the Pallas TPU kernel
`zebrapose_tpu/ops/pnp_kernel.py::minimal_epnp_hypotheses` (body
`_epnp_soa`). N independent 6-point EPnP solves (N = batch ·
n_hypotheses): control points, 12x12 MᵀM, 12x12 Cholesky + k=4 inverse
subspace iteration, L6x10, three beta cases with Gauss-Newton, pose by
scaled-Newton polar, lowest reprojection error wins.

What bounds it on Hopper: operations, not bytes. Each solve reads 39
floats and writes 12 (204 B) but does ~2.4·10⁴ float operations, a
long dependent chain of scalar linear algebra with no reuse across
solves. The TPU kernel put each scalar in an (8, 128) lane tile to keep
1024 solves in lock step on the vector unit. On the GPU a block holds
32 solves: lane l of each of its four warps works on solve l, and the
warps split the solve along the algorithm's parallel axes (MᵀM blocks,
one subspace column and one β case a warp), with the 12x12 state in
shared memory; the source note in `csrc/epnp_minimal.cu` gives the
layout, the occupancy measured and the numerics changes (reciprocal
diagonals, `rsqrtf`, `rcbrtf`).

`minimal_epnp_hypotheses` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; nothing else selects between them.
"""

from __future__ import annotations

import ctypes

import torch

S = 6                      # minimal-set width the kernel is written for


def minimal_epnp_hypotheses_reference(samp3d: torch.Tensor,
                                      samp2d: torch.Tensor,
                                      Ks: torch.Tensor, gn_iters: int = 5):
    """Plain version: the batched weighted EPnP with unit weights, the
    counterpart of `jax.vmap(epnp)` with fast=True. Same arguments and
    results as `minimal_epnp_hypotheses`."""
    from zebrapose_tpu_torch.ops.pnp import epnp

    ones = torch.ones(samp3d.shape[:2], dtype=samp3d.dtype,
                      device=samp3d.device)
    return epnp(samp3d, samp2d, ones, Ks, gn_iters)


def _lib():
    from zebrapose_tpu_torch.ops import _build

    lib = _build.load("epnp_minimal")
    fn = lib.zp_epnp_minimal
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def minimal_epnp_hypotheses(samp3d: torch.Tensor, samp2d: torch.Tensor,
                            Ks: torch.Tensor, gn_iters: int = 5):
    """N independent minimal-set EPnP solves.

    samp3d [N, 6, 3], samp2d [N, 6, 2], Ks [N, 3, 3], float32.
    Returns (Rs [N, 3, 3], ts [N, 3]).
    """
    if samp3d.device.type == "cpu":
        return minimal_epnp_hypotheses_reference(samp3d, samp2d, Ks,
                                                 gn_iters)
    if samp3d.device.type != "cuda":
        raise ValueError(f"unsupported device {samp3d.device}")
    n = samp3d.shape[0]
    for name, x, shape in (("samp3d", samp3d, (n, S, 3)),
                           ("samp2d", samp2d, (n, S, 2)),
                           ("Ks", Ks, (n, 3, 3))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, the "
                             f"kernel takes {shape}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != samp3d.device:
            raise ValueError(f"{name} is on {x.device}, not "
                             f"{samp3d.device}")
    R = torch.empty((n, 3, 3), dtype=torch.float32, device=samp3d.device)
    t = torch.empty((n, 3), dtype=torch.float32, device=samp3d.device)
    if n == 0:
        return R, t
    fn = _lib()
    stream = torch.cuda.current_stream(samp3d.device).cuda_stream
    rc = fn(samp3d.data_ptr(), samp2d.data_ptr(), Ks.data_ptr(),
            R.data_ptr(), t.data_ptr(), n, gn_iters, stream)
    if rc != 0:
        raise RuntimeError(f"zp_epnp_minimal launch failed: CUDA error {rc}")
    minimal_epnp_hypotheses.launches += 1
    return R, t


minimal_epnp_hypotheses.launches = 0


def occupancy() -> dict:
    """The kernel's resources as the CUDA runtime reports them: resident
    blocks per SM, threads and static shared memory a block, registers
    and local (spill) memory a thread."""
    from zebrapose_tpu_torch.ops import _build

    fn = _build.load("epnp_minimal").zp_epnp_minimal_occupancy
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = fn(out)
    if rc != 0:
        raise RuntimeError(f"zp_epnp_minimal_occupancy: CUDA error {rc}")
    return dict(zip(("blocks_per_sm", "threads_per_block",
                     "smem_per_block", "registers", "local_bytes"), out))
