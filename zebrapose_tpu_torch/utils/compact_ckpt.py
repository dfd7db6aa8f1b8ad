"""Compact inference checkpoints (`trained/*.npz`): params and
batch_stats as one .npz.

The port's own copy of `zebrapose_tpu/utils/compact_ckpt.py`
(`load_compact`, `save_compact`, `save_compact_from_run`). Format:
np.savez with leaf paths as keys ("params/<mod>/.../kernel"); float32
leaves are stored as the uint16 bits of their bf16 rounding under a
"__bf16__:" key prefix; a "__meta__" JSON string carries provenance.
bf16 is rounded (to nearest even) and widened here by bit arithmetic (a
bf16 is the top half of an f32), so no `ml_dtypes` is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_BF16_PREFIX = "__bf16__:"
_META_KEY = "__meta__"


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values -> the uint16 bits of their bf16 rounding, as
    `ml_dtypes.bfloat16` rounds: to nearest, ties to even; infinities
    kept; NaN to the quiet NaN 0x7FC0 with the sign kept."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(np.asarray(x, np.float32))
    return np.where(nan, np.where(bits >> 31, 0xFFC0, 0x7FC0),
                    rounded).astype(np.uint16)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in k or k.startswith("__"):
                raise ValueError(f"unsupported key {k!r} under {prefix!r}")
            _flatten(v, f"{prefix}/{k}" if prefix else k, out)
        return
    arr = np.asarray(tree)
    if arr.dtype == np.float32:
        out[_BF16_PREFIX + prefix] = f32_to_bf16_bits(arr)
    else:
        out[prefix] = arr


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


def save_compact(variables: Dict[str, Any], path: str,
                 meta: Optional[Dict[str, Any]] = None) -> None:
    """variables: {"params": ..., "batch_stats": ...} tree of numpy
    arrays; float32 leaves are stored as bf16 (forward-bit-exact for a
    bf16-compute model)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(variables, "", flat)
    flat[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_compact_from_run(run_dir: str, path: str) -> Dict[str, Any]:
    """Export the best checkpoint of a training run dir (the layout the
    port's `fit` writes: `<run>/checkpoints/best/step_N.pth` and
    `best_score.txt`) to a compact npz; the model family is read off the
    checkpoint's keys (`models/convert.py::reference_family`). Returns
    the meta written ({"step", "best_score"})."""
    import torch

    from zebrapose_tpu_torch.models.convert import (
        reference_family,
        state_dict_to_variables,
    )

    best_dir = os.path.join(os.path.abspath(run_dir), "checkpoints", "best")
    steps = sorted((f for f in os.listdir(best_dir)
                    if f.startswith("step_") and f.endswith(".pth")),
                   key=lambda f: int(f[len("step_"):-len(".pth")]))
    if not steps:
        raise FileNotFoundError(f"no step_*.pth under {best_dir}")
    sd = torch.load(os.path.join(best_dir, steps[-1]), map_location="cpu",
                    weights_only=True)["model_state_dict"]
    variant, nonbinary, layers = reference_family(sd)
    with open(os.path.join(best_dir, "best_score.txt")) as f:
        best = f.read().strip()           # "<score> step <N>", as JAX
    meta = {"step": int(steps[-1][len("step_"):-len(".pth")]),
            "best_score": best}
    save_compact(state_dict_to_variables(sd, variant, nonbinary, layers),
                 path, meta)
    return meta
