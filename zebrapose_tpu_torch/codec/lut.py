"""Class-id -> 3D-point correspondence lookup table (host side, numpy).

The port's own copy of `zebrapose_tpu/codec/lut.py` (that package's
`codec/__init__.py` imports JAX, so it cannot be imported from here).
Invalid classes (NaN rows in the file) map to (0, 0, 0) with
valid=False.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorrespondenceLUT:
    """Dense class-id -> region-centroid table.

    points: float32[num_classes, 3], zeros where invalid.
    valid:  bool[num_classes].
    base:   digits-per-level d.
    n_digits: number of levels n.
    """

    points: np.ndarray
    valid: np.ndarray
    base: int
    n_digits: int

    @property
    def num_classes(self) -> int:
        return self.points.shape[0]


def load_correspondence_lut(path: str) -> CorrespondenceLUT:
    """Parse a reference-format `Class_CorresPoint*.txt`: a header line
    `total_classes divide_number n_iterations`, then `class_id x y z`
    lines (values may be `nan`)."""
    with open(path, "r") as f:
        header = f.readline().split()
        total = int(float(header[0]))
        base = int(float(header[1]))
        n_digits = int(float(header[2]))
        data = np.loadtxt(f, dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    points = np.zeros((total, 3), dtype=np.float32)
    valid = np.zeros((total,), dtype=bool)
    ids = data[:, 0].astype(np.int64)
    xyz = data[:, 1:4]
    ok = ~np.isnan(xyz).any(axis=1)
    points[ids[ok]] = xyz[ok].astype(np.float32)
    valid[ids[ok]] = True
    return CorrespondenceLUT(points=points, valid=valid, base=base,
                             n_digits=n_digits)


def save_correspondence_lut(path: str, lut: CorrespondenceLUT) -> None:
    """Write a LUT in the reference text format (`load_correspondence_lut`
    reads it back)."""
    with open(path, "w") as f:
        f.write(f"{lut.num_classes} {lut.base} {lut.n_digits}\n")
        for i in range(lut.num_classes):
            if lut.valid[i]:
                x, y, z = (float(v) for v in lut.points[i])
                f.write(f"{i} {x} {y} {z}\n")
            else:
                f.write(f"{i} nan nan nan\n")


def reduce_lut_ignore_bits(lut: CorrespondenceLUT,
                           ignore_bits: int) -> CorrespondenceLUT:
    """Drop the last `ignore_bits` levels: new point = mean over the
    group; a group with any invalid member becomes invalid."""
    if ignore_bits == 0:
        return lut
    group = lut.base ** ignore_bits
    n_new = lut.num_classes // group
    pts = lut.points.reshape(n_new, group, 3)
    val = lut.valid.reshape(n_new, group)
    all_valid = val.all(axis=1)
    mean_pts = pts.mean(axis=1)
    mean_pts = np.where(all_valid[:, None], mean_pts, 0.0).astype(np.float32)
    return CorrespondenceLUT(points=mean_pts, valid=all_valid,
                             base=lut.base,
                             n_digits=lut.n_digits - ignore_bits)
