"""Multi-instance ("vivo") evaluation — the reference test_vivo.py path.

Port of `zebrapose_tpu/eval/vivo.py`. Every (image, instance) pair is
flattened into one instance list up front (images in walk order, each
image's detections in file order) and pushed through the same batched
eval program as the single-instance path: the variable instance count
is a host-side list length, never a device-side dynamic shape.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from zebrapose_tpu_torch.data.bop_writer import parse_sample_ids, write_csv
from zebrapose_tpu_torch.data.detections import all_instances
from zebrapose_tpu_torch.data.pipeline import CropDatasetHost
from zebrapose_tpu_torch.eval.evaluate import run_inference


def build_vivo_dataset(dataset_dir: str, data_folder: str,
                       rgb_files: Sequence[str],
                       cam_params_by_file: Dict[str, dict],
                       detections: Dict[str, list], obj_id: int,
                       score_threshold: float = 0.2,
                       crop_size_img: int = 256, crop_size_gt: int = 128,
                       padding_ratio: float = 1.5,
                       resize_method: str = "crop_square_resize",
                       use_segmentation: bool = False,
                       roi_slice: bool = False
                       ) -> Tuple[CropDatasetHost, List[float]]:
    """Flatten per-image detection lists into a per-instance dataset.

    cam_params_by_file: rgb path -> {"cam_K": [3,3]}. Returns the dataset
    (GT-less entries) plus per-instance detector scores (carried into the
    CSV like test_vivo.py:187-190). With use_segmentation, each
    instance's detector RLE replaces its visible mask (the Mask-RCNN
    variant, test_vivo_for_mask_rcnn.py).
    """
    per_image = all_instances(detections, list(rgb_files), obj_id,
                              score_threshold)
    rgb, bboxes, scores, cams, segs = [], [], [], [], []
    for fn in rgb_files:
        for det in per_image.get(fn, []):
            rgb.append(fn)
            bboxes.append(np.asarray(det["bbox_est"]))
            scores.append(det["score"])
            cams.append(cam_params_by_file[fn])
            segs.append(det.get("segmentation"))
    n = len(rgb)
    dataset = CropDatasetHost(
        dataset_dir, data_folder, rgb,
        mask_files=[[""]] * n, mask_visib_files=[[""]] * n,
        gts=[None] * n, gt_infos=[None] * n, cam_params=cams,
        is_train=False, crop_size_img=crop_size_img,
        crop_size_gt=crop_size_gt, padding_ratio=padding_ratio,
        resize_method=resize_method, detect_bboxes=bboxes,
        detect_segmentations=segs if use_segmentation else None,
        roi_slice=roi_slice)
    return dataset, scores


def evaluate_vivo(dataset: CropDatasetHost, scores: Sequence[float],
                  eval_step, obj_id: int, dataset_name: str,
                  obj_name: str, output_dir: Optional[str] = None,
                  batch_size: int = 16, device=None,
                  draws_for: Optional[Callable] = None,
                  timing: Optional[Dict[str, float]] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run pose estimation for every instance (`run_inference` on
    `device`, CUDA unless "cpu" is asked for; `draws_for` and `timing`
    as there); the CSV rows in `output_dir/pose_result_bop` carry the
    detector scores, and failed instances are dropped (score -1)."""
    Rs, ts, ok = run_inference(dataset, eval_step, batch_size,
                               device=device, draws_for=draws_for,
                               timing=timing)
    out_scores = [s if k else -1 for s, k in zip(scores, ok)]
    if output_dir is not None:
        ids = parse_sample_ids(dataset.rgb_files)
        write_csv(os.path.join(output_dir, "pose_result_bop"),
                  f"{dataset_name}_{obj_name}", obj_id,
                  [s for s, _ in ids], [i for _, i in ids],
                  list(Rs), [t.reshape(3, 1) for t in ts], out_scores)
    return Rs, ts, ok
