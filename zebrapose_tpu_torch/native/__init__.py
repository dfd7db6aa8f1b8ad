"""ctypes bindings for the port's host C++ library: the rasterizer.

Port of the rasterizer half of `zebrapose_tpu/native/__init__.py`.
`csrc/zebra_native.cpp` holds a copy of the JAX package's
`zn_render_label` with the same C interface; `ops/_build.py` compiles it
at first use with the flags of `native/Makefile` (c++ or `$CXX`, no fast
math), so ids and depth are bit-equal to the JAX package's library. It
is host code in both stacks, not a kernel and not a fallback: there is
no Python rasterizer, and a missing compiler raises. The partitioner and
`edge_refine` are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np


def _lib():
    from zebrapose_tpu_torch.ops import _build

    fn = _build.load("zebra_native").zn_render_label
    if fn.argtypes is None:
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        c_int = ctypes.c_int
        fn.argtypes = [f32p, c_int, i32p, c_int, i32p, f64p, f64p, f64p,
                       c_int, c_int, i32p, ctypes.c_void_p]
        fn.restype = c_int
    return fn


def render_label(vertices: np.ndarray, faces: np.ndarray,
                 face_class: np.ndarray, K: np.ndarray, R: np.ndarray,
                 t: np.ndarray, width: int, height: int,
                 with_depth: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Render per-pixel face class ids (0 = background) and optional
    depth under x_c = R X + t."""
    fn = _lib()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    fc = np.ascontiguousarray(face_class, np.int32)
    Kc, Rc, tc = (np.ascontiguousarray(a, np.float64).reshape(-1)
                  for a in (K, R, t))
    if (v.ndim != 2 or v.shape[1] != 3 or len(fc) != len(f)
            or (Kc.size, Rc.size, tc.size) != (9, 9, 3)
            or (f.size and (f.min() < 0 or f.max() >= len(v)))):
        raise ValueError("render_label: vertices [V, 3], faces [F, 3] "
                         "indexing them, one class a face, K and R 3x3, "
                         "t of 3")
    out = np.zeros((height, width), np.int32)
    depth = np.zeros((height, width), np.float32) if with_depth else None
    rc = fn(v, len(v), f, len(f), fc, Kc, Rc, tc, width, height, out,
            depth.ctypes.data_as(ctypes.c_void_p) if with_depth else None)
    if rc != 0:
        raise RuntimeError(f"zn_render_label failed: {rc}")
    return out, depth
