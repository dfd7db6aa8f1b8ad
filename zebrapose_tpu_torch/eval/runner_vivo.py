"""Vivo (multi-instance) test-run orchestration — test_vivo.py main.

Port of `zebrapose_tpu/eval/runner_vivo.py`: the GT-less image walk,
every detection above the score threshold, the model and eval program of
the `test` runner (`eval/runner.py`), the score-carrying BOP CSV, on the
device (CUDA unless "cpu" is asked for), with the int8 serving convs
under `int8`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data import bop_io
from zebrapose_tpu_torch.data import detections as det_mod
from zebrapose_tpu_torch.data.dataset_info import lookup_obj_id
from zebrapose_tpu_torch.eval.runner import build_eval_step, load_model
from zebrapose_tpu_torch.eval.vivo import build_vivo_dataset, evaluate_vivo
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.utils.device import resolve_device


def run_vivo(cfg: ZebraConfig, obj_name: str, ckpt_file: str,
             output_dir: str, variant: str = "v2",
             score_threshold: float = 0.2, batch_size: int = 16,
             pnp_cfg: Optional[PnPConfig] = None,
             mask_rcnn: bool = False,
             int8: bool = False,
             roi_slice: bool = False,
             device=None) -> Dict[str, float]:
    """Pose every detected instance of one object in the split: the CSV
    `output_dir/pose_result_bop/<dataset>_<obj>.csv` (solved instances,
    each with its detection's score) and {"instances", "solved",
    "solve_rate"}. Prints a `timing {...}` line (seconds by stage, as
    `run_test` does). int8: the int8 serving convs, as in `run_test`."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)

    # Vivo iterates IMAGES (not GT instances): build the image list from
    # scene_camera.json + detections alone so GT-less challenge splits
    # work (reference test_vivo.py:127-131 reads cameras per scene
    # directly and drives the loop off the detection dict).
    rgb_files, cam_by_file = bop_io.list_images_with_cameras(
        cfg.bop_path, cfg.dataset_name, data_folder=cfg.test_folder)
    dataset_dir = os.path.join(cfg.bop_path, cfg.dataset_name)

    dets = det_mod.load_detections(cfg.Detection_reaults)
    dataset, scores = build_vivo_dataset(
        dataset_dir, cfg.test_folder, rgb_files, cam_by_file,
        dets, obj_id, score_threshold,
        crop_size_img=cfg.BoundingBox_CropSize_image,
        crop_size_gt=cfg.BoundingBox_CropSize_GT,
        padding_ratio=cfg.padding_ratio,
        resize_method=cfg.resize_method,
        use_segmentation=mask_rcnn, roi_slice=roi_slice)

    lut = load_correspondence_lut(os.path.join(
        cfg.bop_path, cfg.dataset_name, "models_GT_color",
        f"Class_CorresPoint{obj_id:06d}.txt"))
    t1 = time.perf_counter()
    model = load_model(cfg, ckpt_file, variant, device=dev, quant=int8)
    step = build_eval_step(cfg, model, lut, pnp_cfg or PnPConfig(),
                           mask_rcnn=mask_rcnn, device=dev)
    t2 = time.perf_counter()

    timing: Dict[str, float] = {}
    _, _, ok = evaluate_vivo(dataset, scores, step, obj_id,
                             cfg.dataset_name, obj_name,
                             output_dir=output_dir, batch_size=batch_size,
                             device=dev, timing=timing)
    # where this run's time went, in seconds (run_inference's stages;
    # write_s: the CSV)
    timing["write_s"] = (time.perf_counter() - t2
                         - timing.get("inference_s", 0.0))
    print("timing " + json.dumps(dict(
        prepare_s=t1 - t0, load_model_s=t2 - t1, **timing)))
    return {"instances": int(len(dataset)),
            "solved": int(np.sum(ok)),
            "solve_rate": float(np.mean(ok)) if len(dataset) else 0.0}
