"""Symmetry-aware GT pose canonicalization (the `*_GT_v2` label recipe).

The port's copy of `zebrapose_tpu/tools/symmetry.py` (numpy, no JAX).
Re-creates modified_gt_for_symmetry
(`Binary_Code_GT_Generator/generate_training_labels_for_BOP_v2.py:88-208`):
before rendering a GT label image, the pose is rotated into the canonical
representative of its symmetry class — argmin over the object's symmetry
transforms S of ||R S - I||_F. Discrete symmetries enumerate; continuous
axis symmetries (x/y/z through the origin) have the closed-form theta the
reference derives; combined discrete+continuous composes both. Several
continuous symmetries, one with an offset, and a discrete set with a
continuous symmetry about x or y raise NotImplementedError, as in the JAX
package.

model_info: the BOP models_info.json entry (symmetries_discrete as flat
4x4 row-major lists, symmetries_continuous as {axis, offset}).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _axis_theta(R: np.ndarray, axis: str) -> float:
    """Closed-form rotation angle about `axis` minimizing ||R S - I||."""
    if axis == "z":
        a, b = R[0, 0] + R[1, 1], R[0, 1] - R[1, 0]
        theta = np.arctan(b / a)
        if not (np.sin(theta) * (-b) < np.cos(theta) * a):
            theta += np.pi
    elif axis == "y":
        a, b = R[0, 0] + R[2, 2], R[2, 0] - R[0, 2]
        theta = np.arctan(b / a)
        if not (np.sin(theta) * (-b) < np.cos(theta) * a):
            theta += np.pi
    elif axis == "x":
        a, b = R[1, 1] + R[2, 2], R[2, 1] - R[1, 2]
        theta = np.arctan(b / a)
        if not (a * np.cos(theta) + b * np.sin(theta) > 0):
            theta += np.pi
    else:
        raise NotImplementedError(axis)
    return float(theta)


def _axis_rot(theta: float, axis: str) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _axis_name(axis_vec) -> str:
    mapping = {(1, 0, 0): "x", (0, 1, 0): "y", (0, 0, 1): "z"}
    key = tuple(int(v) for v in axis_vec)
    if key not in mapping:
        raise NotImplementedError(f"unsupported symmetry axis {axis_vec}")
    return mapping[key]


def _discrete_syms(model_info: Dict):
    syms = [(np.eye(3), np.zeros((3, 1)))]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, np.float64), (4, 4))
        syms.append((m[:3, :3], m[:3, 3].reshape(3, 1)))
    return syms


def canonicalize_pose(R: np.ndarray, t: np.ndarray,
                      model_info: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t [3,1]) -> canonical representative under the object's
    symmetries. No symmetries -> unchanged."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    t = np.asarray(t, np.float64).reshape(3, 1)
    has_cont = "symmetries_continuous" in model_info
    has_disc = "symmetries_discrete" in model_info
    if not has_cont and not has_disc:
        return R, t

    if has_cont:
        conts = model_info["symmetries_continuous"]
        if len(conts) != 1:
            raise NotImplementedError("multiple continuous symmetries")
        if list(conts[0].get("offset", [0, 0, 0])) != [0, 0, 0]:
            raise NotImplementedError("continuous symmetry with offset")
        axis = _axis_name(conts[0]["axis"])
        if has_disc and axis != "z":
            raise NotImplementedError(
                "combined discrete + non-z continuous symmetry")

    candidates = []
    for Rs, ts in (_discrete_syms(model_info) if has_disc
                   else [(np.eye(3), np.zeros((3, 1)))]):
        Rc = R @ Rs
        tc = R @ ts + t
        if has_cont:
            theta = _axis_theta(Rc, axis)
            Rc = Rc @ _axis_rot(theta, axis)
        candidates.append((Rc, tc))

    best = min(candidates,
               key=lambda p: np.linalg.norm(p[0] - np.eye(3)))
    return best[0], best[1]
