"""BOP-challenge CSV export + per-object merge.

Same row contract as the reference (`tools_for_BOP/write_to_cvs.py`):
`scene_id,im_id,obj_id,score,R(9 space-sep),t(3 space-sep),time=-1`, with
score==-1 rows dropped; `merge_csv` concatenates per-object CSVs into one
submission file (reference merge_csv.py). The port's copy of
`zebrapose_tpu/data/bop_writer.py`.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence

import numpy as np


def write_csv(out_dir: str, filename: str, obj_id: int,
              scene_ids: Sequence[int], img_ids: Sequence[int],
              rotations: Sequence[np.ndarray],
              translations: Sequence[np.ndarray],
              scores: Sequence[float]) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename + ".csv")
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for scene, im, R, t, score in zip(scene_ids, img_ids, rotations,
                                          translations, scores):
            if score == -1:
                continue
            R = np.asarray(R).reshape(3, 3)
            t = np.asarray(t).reshape(3)
            r_str = " ".join(str(v) for v in R.reshape(-1))
            t_str = " ".join(str(v) for v in t)
            f.write(f"{scene},{im},{obj_id},{score},{r_str},{t_str},-1\n")
    return path


def merge_csv(csv_paths: Iterable[str], out_path: str) -> str:
    """Concatenate per-object CSVs (one header) into a submission file."""
    rows: List[str] = []
    for p in csv_paths:
        with open(p) as f:
            lines = f.read().splitlines()
        rows.extend(lines[1:])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for r in rows:
            if r.strip():
                f.write(r + "\n")
    return out_path


def parse_sample_ids(rgb_fns: Sequence[str]):
    """(scene_id, im_id) pairs from BOP rgb paths."""
    out = []
    for fn in rgb_fns:
        parts = fn.split("/")
        out.append((int(parts[-3]), int(os.path.splitext(parts[-1])[0])))
    return out
