"""ctypes bindings for the port's host C++ library: the rasterizer and the
surface partitioner.

Port of `zebrapose_tpu/native/__init__.py` (`render_label`,
`partition_mesh`, `face_classes`, `class_centroids`).
`csrc/zebra_native.cpp` holds a copy of the JAX package's functions with
the same C interface; `ops/_build.py` compiles it at first use with the
flags of `native/Makefile` (c++ or `$CXX`, no fast math), so ids, depth,
partitions and centroids are bit-equal to the JAX package's library
built by the same compiler. It is host code in both stacks, not a kernel
and not a fallback: there is no Python rasterizer or partitioner, and a
missing compiler raises. `edge_refine` is not ported yet (ROADMAP.md,
queue A).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_int = ctypes.c_int
_SIGNATURES = {
    "zn_render_label": [_f32p, _int, _i32p, _int, _i32p, _f64p, _f64p,
                        _f64p, _int, _int, _i32p, ctypes.c_void_p],
    "zn_partition_mesh": [_f32p, _int, _int, _int, ctypes.c_uint32, _u32p],
    "zn_face_classes": [_u32p, _i32p, _int, _u32p],
    "zn_class_centroids": [_f32p, _int, _u32p, _int, _f32p],
}


def _lib() -> ctypes.CDLL:
    from zebrapose_tpu_torch.ops import _build

    lib = _build.load("zebra_native")
    if lib.zn_render_label.argtypes is None:
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _int
    return lib


def _vertices(vertices: np.ndarray, what: str) -> np.ndarray:
    v = np.ascontiguousarray(vertices, np.float32)
    if v.ndim != 2 or v.shape[1] != 3:
        raise ValueError(f"{what}: vertices [V, 3], not {v.shape}")
    return v


def _faces(faces: np.ndarray, n_vertices: int, what: str) -> np.ndarray:
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= n_vertices):
        raise ValueError(f"{what}: faces [F, 3] must index the "
                         f"{n_vertices} vertices")
    return f


def render_label(vertices: np.ndarray, faces: np.ndarray,
                 face_class: np.ndarray, K: np.ndarray, R: np.ndarray,
                 t: np.ndarray, width: int, height: int,
                 with_depth: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Render per-pixel face class ids (0 = background) and optional
    depth under x_c = R X + t."""
    lib = _lib()
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
    rc = lib.zn_render_label(
        v, len(v), f, len(f), fc, Kc, Rc, tc, width, height, out,
        depth.ctypes.data_as(ctypes.c_void_p) if with_depth else None)
    if rc != 0:
        raise RuntimeError(f"zn_render_label failed: {rc}")
    return out, depth


def partition_mesh(vertices: np.ndarray, divide_number: int,
                   n_levels: int, seed: int = 0) -> np.ndarray:
    """Hierarchical balanced surface encoding: per-vertex class id in
    [0, divide_number**n_levels) (uint32)."""
    lib = _lib()
    v = _vertices(vertices, "partition_mesh")
    if divide_number < 1 or n_levels < 0 or \
            divide_number ** n_levels > 2 ** 32:
        raise ValueError(f"partition_mesh: {divide_number}^{n_levels} "
                         "classes do not fit uint32 ids")
    out = np.zeros((len(v),), np.uint32)
    rc = lib.zn_partition_mesh(v, len(v), divide_number, n_levels,
                               seed, out)
    if rc != 0:
        raise RuntimeError(f"zn_partition_mesh failed: {rc}")
    return out


def face_classes(vertex_class: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Each face's class from its vertices' (uint32): the class two of
    them share, else the first vertex's."""
    lib = _lib()
    vc = np.ascontiguousarray(vertex_class, np.uint32).reshape(-1)
    f = _faces(faces, len(vc), "face_classes")
    out = np.zeros((len(f),), np.uint32)
    lib.zn_face_classes(vc, f, len(f), out)
    return out


def class_centroids(vertices: np.ndarray, vertex_class: np.ndarray,
                    n_classes: int) -> np.ndarray:
    """[n_classes, 3] centroids; NaN rows for empty classes."""
    lib = _lib()
    v = _vertices(vertices, "class_centroids")
    vc = np.ascontiguousarray(vertex_class, np.uint32).reshape(-1)
    if len(vc) != len(v):
        raise ValueError("class_centroids: one class a vertex")
    out = np.zeros((n_classes, 3), np.float32)
    lib.zn_class_centroids(v, len(v), vc, n_classes, out)
    return out
