"""Reader for compact inference checkpoints (`trained/*.npz`).

The port's own copy of `zebrapose_tpu/utils/compact_ckpt.py::
load_compact`. Format: np.savez with leaf paths as keys
("params/<mod>/.../kernel"); float32 leaves are stored as the uint16
bits of their bf16 rounding under a "__bf16__:" key prefix; a
"__meta__" JSON string carries provenance. bf16 is widened here by a
bit shift (a bf16 is the top half of an f32), so no `ml_dtypes` is
needed.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np

_BF16_PREFIX = "__bf16__:"
_META_KEY = "__meta__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _insert(tree: Dict[str, Any], path: str, leaf: np.ndarray) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def load_compact(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (variables, meta): the {"params", "batch_stats"} tree of
    numpy leaves, bf16-stored leaves widened to float32."""
    tree: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key == _META_KEY:
                meta = json.loads(z[key].tobytes().decode())
            elif key.startswith(_BF16_PREFIX):
                _insert(tree, key[len(_BF16_PREFIX):],
                        bf16_bits_to_f32(z[key]))
            else:
                _insert(tree, key, z[key])
    return tree, meta
