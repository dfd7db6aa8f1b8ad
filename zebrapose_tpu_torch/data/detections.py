"""Detector-output ingestion (FCOS/FasterRCNN/yolov3 JSONs).

Format (reference `get_detection_results.py`): a dict keyed
"{scene_id}/{im_id}" whose values are lists of
{"obj_id": int, "bbox_est": [x, y, w, h], "score": float}.

The port's copy of `zebrapose_tpu/data/detections.py`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def _sample_key(rgb_fn: str) -> str:
    parts = rgb_fn.split("/")
    scene_id = int(parts[-3])
    img_id = int(os.path.splitext(parts[-1])[0])
    return f"{scene_id}/{img_id}"


def load_detections(path: str) -> Dict[str, list]:
    with open(path) as f:
        return json.load(f)


def best_bboxes(detections: Dict[str, list], rgb_fns: List[str],
                obj_id: int, score_thr: float = 0.0
                ) -> List[Optional[np.ndarray]]:
    """Highest-scoring detection of `obj_id` per image (or None).
    Ref: get_detection_results."""
    out: List[Optional[np.ndarray]] = [None] * len(rgb_fns)
    for i, fn in enumerate(rgb_fns):
        best = 0.0
        for d in detections.get(_sample_key(fn), []):
            if d["score"] < score_thr or d["obj_id"] != obj_id:
                continue
            if d["score"] > best:
                best = d["score"]
                out[i] = np.array([int(v) for v in d["bbox_est"]],
                                  np.int64)
    return out


def best_scores(detections: Dict[str, list], rgb_fns: List[str],
                obj_id: int, score_thr: float = 0.0) -> List[float]:
    """Score of the best detection per image, -1 when none.
    Ref: get_detection_scores."""
    out = [-1.0] * len(rgb_fns)
    for i, fn in enumerate(rgb_fns):
        best = 0.0
        for d in detections.get(_sample_key(fn), []):
            if d["score"] < score_thr or d["obj_id"] != obj_id:
                continue
            if d["score"] > best:
                best = d["score"]
                out[i] = best
    return out


def all_instances(detections: Dict[str, list], rgb_fns: List[str],
                  obj_id: int, score_thr: float = 0.2
                  ) -> Dict[str, List[dict]]:
    """ALL detections >= threshold per image, for the multi-instance
    (test_vivo) path. Ref: get_detection_results_vivo."""
    out: Dict[str, List[dict]] = {}
    for fn in rgb_fns:
        for d in detections.get(_sample_key(fn), []):
            if d["score"] < score_thr or d["obj_id"] != obj_id:
                continue
            entry = {"bbox_est": np.array(
                [int(v) for v in d["bbox_est"]], np.int64),
                "score": float(d["score"])}
            if "segmentation" in d:  # Mask-RCNN detector output
                entry["segmentation"] = d["segmentation"]
            out.setdefault(fn, []).append(entry)
    return out


def decode_rle(segmentation: dict) -> np.ndarray:
    """Uncompressed COCO RLE -> uint8 {0,1} mask [H, W].

    Column-major counts starting with background, as consumed by the
    reference's Mask-RCNN dataset variant
    (bop_dataset_pytorch_mask_rcnn.py:270-287), vectorized with
    np.repeat instead of the per-pixel loop.
    """
    counts = np.asarray(segmentation["counts"], np.int64)
    h, w = segmentation["size"]
    if counts.sum() != h * w:
        raise ValueError("RLE counts do not cover the mask")
    vals = np.arange(len(counts)) % 2  # 0,1,0,1,... starting background
    flat = np.repeat(vals.astype(np.uint8), counts)
    return flat.reshape((h, w), order="F")


def best_segmentations(detections: Dict[str, list], rgb_fns: List[str],
                       obj_id: int, score_thr: float = 0.0
                       ) -> List[Optional[dict]]:
    """Highest-scoring detection's RLE segmentation per image (or None),
    the Mask-RCNN input path."""
    out: List[Optional[dict]] = [None] * len(rgb_fns)
    for i, fn in enumerate(rgb_fns):
        best = 0.0
        for d in detections.get(_sample_key(fn), []):
            if d["score"] < score_thr or d["obj_id"] != obj_id:
                continue
            if d["score"] > best and "segmentation" in d:
                best = d["score"]
                out[i] = d["segmentation"]
    return out


def keyframe_indices(detections: Dict[str, list],
                     rgb_fns: List[str]) -> List[int]:
    """Indices whose image appears in the detection dict (the YCB-V
    keyframe subset). Ref: ycbv_select_keyframe."""
    return [i for i, fn in enumerate(rgb_fns)
            if _sample_key(fn) in detections]
