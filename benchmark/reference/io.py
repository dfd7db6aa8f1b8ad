"""Readers of the committed `.npz` files, the reference's own: the
compact checkpoint (leaf paths as keys, float32 leaves stored as the
uint16 bits of their bf16 rounding under "__bf16__:") and the surface
code's LUT (points [C, 3], valid [C])."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .convert import variables_to_state_dict

_BF16_PREFIX = "__bf16__:"


def _insert(tree: Dict[str, Any], path: str, leaf: np.ndarray) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def load_variables(path: str) -> Dict[str, Any]:
    """The {"params", "batch_stats"} tree of a compact checkpoint, bf16
    leaves widened to float32 (a bf16 is the top half of an f32)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key == "__meta__":
                continue
            if key.startswith(_BF16_PREFIX):
                bits = z[key].astype(np.uint32) << 16
                _insert(tree, key[len(_BF16_PREFIX):], bits.view(np.float32))
            else:
                _insert(tree, key, z[key])
    return tree


def checkpoint_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A v2 ResNet34 checkpoint as the reference network's state dict."""
    return variables_to_state_dict(load_variables(path))


def load_lut(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(points float32 [C, 3], valid bool [C]) of a LUT `.npz`."""
    with np.load(path) as z:
        return (np.asarray(z["points"], np.float32),
                np.asarray(z["valid"], bool))
