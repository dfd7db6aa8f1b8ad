"""Test-run orchestration: the reference test.py main.

Port of `zebrapose_tpu/eval/runner.py` (`load_model_variables`,
`ObjectEval`, `prepare_object_eval`, `run_test`). Assembles dataset +
detections + LUT + model + eval program from a ZebraConfig and runs the
evaluation on the device (CUDA unless "cpu" is asked for).

Not ported yet (ROADMAP.md, queue A), and refused with
NotImplementedError: orbax checkpoint directories, the contour
refinement pass (`cfg.refine`, which needs the native `edge_refine`),
`debug` dumps (`utils/visualize.py`) and int8 serving.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data import bop_io
from zebrapose_tpu_torch.data import detections as det_mod
from zebrapose_tpu_torch.data.dataset_info import is_symmetric, lookup_obj_id
from zebrapose_tpu_torch.data.pipeline import CropDatasetHost
from zebrapose_tpu_torch.eval.evaluate import evaluate_object, make_eval_step
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.utils.device import resolve_device

_UNPORTED = "is not ported yet (see ROADMAP.md, queue A)"


def load_model_variables(ckpt_file: str, variant: str = "v2"
                         ) -> Dict[str, torch.Tensor]:
    """A checkpoint's weights as a state dict of the port's ZebraPoseNet
    (whose names are the reference checkpoints' keys): a compact `.npz`
    (`utils/compact_ckpt.py`, converted by `models/convert.py`) or a
    reference-format `.pth` / `.pt` (`models/convert.py::
    reference_state_dict`: DDP prefixes stripped, absent skip-tap aliases
    filled)."""
    if ckpt_file.endswith(".npz"):
        from zebrapose_tpu_torch.models.convert import variables_to_state_dict
        from zebrapose_tpu_torch.utils.compact_ckpt import load_compact
        variables, _ = load_compact(ckpt_file)
        return variables_to_state_dict(variables, variant)
    if ckpt_file.endswith((".pth", ".pt")):
        from zebrapose_tpu_torch.models.convert import reference_state_dict
        ckpt = torch.load(ckpt_file, map_location="cpu", weights_only=True)
        return reference_state_dict(ckpt.get("model_state_dict", ckpt))
    raise NotImplementedError(
        f"checkpoint {ckpt_file!r}: orbax checkpoint directories "
        + _UNPORTED + "; pass a .npz or a reference .pth")


def load_model(cfg: ZebraConfig, ckpt_file: str, variant: str = "v2",
               device=None) -> ZebraPoseNet:
    """The config's ZebraPoseNet with the checkpoint's weights (strict),
    in eval mode on `device`, channels-last."""
    dev = resolve_device(device)
    model = ZebraPoseNet(
        binary_code_length=cfg.number_of_itration,
        base=cfg.divide_number_each_itration, variant=variant,
        resnet_layers=cfg.resnet_layer,
        concat=cfg.concat_encoder_decoder,
        output_kernel_size=cfg.output_kernel_size)
    model.load_state_dict(load_model_variables(ckpt_file, variant),
                          strict=True)
    return model.eval().to(dev).to(memory_format=torch.channels_last)


def build_eval_step(cfg: ZebraConfig, model: ZebraPoseNet, lut,
                    pnp_cfg: PnPConfig, ignore_bit: int = 0,
                    mask_rcnn: bool = False, device=None):
    """run_test's batch program for `model` (make_eval_step with the
    config's crop sizes, code and resize method)."""
    return make_eval_step(
        lambda b: model(b["image"]), lut,
        crop_img=cfg.BoundingBox_CropSize_image,
        crop_gt=cfg.BoundingBox_CropSize_GT,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=pnp_cfg,
        ignore_bits=ignore_bit, mask_from_dataset=mask_rcnn,
        preprocess_gt=False, device=device)


class ObjectEval:
    """Everything run_test needs per object."""

    def __init__(self, obj_id, dataset, scores, lut, mesh, vertices,
                 diameter, symmetric):
        self.obj_id, self.dataset, self.scores = obj_id, dataset, scores
        self.lut, self.mesh = lut, mesh
        self.vertices, self.diameter = vertices, diameter
        self.symmetric = symmetric


def prepare_object_eval(cfg: ZebraConfig, obj_name: str,
                        max_samples: Optional[int] = None,
                        mask_rcnn: bool = False,
                        roi_slice: bool = False) -> ObjectEval:
    """Assemble one object's eval inputs: BOP walk (+BOP-challenge
    targets), detection ingestion (+ycbv keyframes), dataset, LUT, mesh
    geometry (test.py:85-240 setup)."""
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)

    if cfg.bop_challange:
        samples = bop_io.get_bop_challenge_test_data(
            cfg.bop_path, cfg.dataset_name, obj_id,
            data_folder=cfg.test_folder)
    else:
        samples = bop_io.get_dataset(cfg.bop_path, cfg.dataset_name,
                                     train=False, eval_model=True,
                                     data_folder=cfg.test_folder)
    lists = list(samples.for_obj(obj_id))

    det_bboxes = None
    det_segs = None
    scores = None
    if cfg.Detection_reaults not in ("none", "", None):
        dets = det_mod.load_detections(cfg.Detection_reaults)
        if cfg.dataset_name == "ycbv":
            keep = det_mod.keyframe_indices(dets, lists[0])
            lists = [np.asarray(lst, dtype=object)[keep].tolist()
                     for lst in lists]
        det_bboxes = det_mod.best_bboxes(dets, lists[0], obj_id)
        scores = det_mod.best_scores(dets, lists[0], obj_id)
        if mask_rcnn:
            det_segs = det_mod.best_segmentations(dets, lists[0], obj_id)
    elif mask_rcnn:
        raise ValueError("mask_rcnn requires Detection_reaults with "
                         "RLE segmentations")
    if max_samples is not None:
        lists = [lst[:max_samples] for lst in lists]
        if det_bboxes is not None:
            det_bboxes = det_bboxes[:max_samples]
            scores = scores[:max_samples]
        if det_segs is not None:
            det_segs = det_segs[:max_samples]

    dataset = CropDatasetHost(
        samples.dataset_dir, cfg.test_folder, *lists, is_train=False,
        crop_size_img=cfg.BoundingBox_CropSize_image,
        crop_size_gt=cfg.BoundingBox_CropSize_GT,
        padding_ratio=cfg.padding_ratio, resize_method=cfg.resize_method,
        detect_bboxes=det_bboxes,
        detect_segmentations=det_segs, roi_slice=roi_slice)

    lut = load_correspondence_lut(os.path.join(
        cfg.bop_path, cfg.dataset_name, "models_GT_color",
        f"Class_CorresPoint{obj_id:06d}.txt"))
    mesh = bop_io.load_ply(samples.model_plys[obj_id])
    return ObjectEval(
        obj_id, dataset, scores, lut, mesh,
        mesh["pts"].astype(np.float32),
        float(samples.model_info[str(obj_id)]["diameter"]),
        is_symmetric(cfg.dataset_name, obj_name))


def run_test(cfg: ZebraConfig, obj_name: str, ckpt_file: str,
             output_dir: str, ignore_bit: int = 0, variant: str = "v2",
             debug: bool = False, batch_size: int = 16,
             pnp_cfg: Optional[PnPConfig] = None,
             max_samples: Optional[int] = None,
             mask_rcnn: bool = False,
             int8: bool = False,
             roi_slice: bool = False,
             device=None) -> Dict[str, float]:
    """Single-instance evaluation of one object (test.py main): metrics,
    plus the BOP CSV, add_err.txt and ADD_result.txt in `output_dir` and
    the metrics appended to its log.txt.

    mask_rcnn: the detector's RLE segmentation replaces the network's
    mask head (reference test_for_mask_rcnn.py). roi_slice: the host
    ships only each frame's clamped square-bbox bytes (bit-identical
    crops)."""
    if int8:
        raise NotImplementedError("int8 inference " + _UNPORTED)
    if cfg.refine:
        raise NotImplementedError(
            "cfg.refine (contour refinement, native edge_refine) "
            + _UNPORTED)
    if debug:
        raise NotImplementedError(
            "debug dumps (utils/visualize.py) " + _UNPORTED)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    oe = prepare_object_eval(cfg, obj_name, max_samples=max_samples,
                             mask_rcnn=mask_rcnn, roi_slice=roi_slice)
    t1 = time.perf_counter()
    model = load_model(cfg, ckpt_file, variant, device=dev)
    step = build_eval_step(cfg, model, oe.lut, pnp_cfg or PnPConfig(),
                           ignore_bit=ignore_bit, mask_rcnn=mask_rcnn,
                           device=dev)
    t2 = time.perf_counter()
    res = evaluate_object(
        oe.dataset, step, oe.vertices, oe.diameter, oe.symmetric,
        oe.obj_id, cfg.dataset_name, obj_name, output_dir=output_dir,
        scores=oe.scores, batch_size=batch_size, device=dev)
    # where this run's time went, in seconds (evaluate_object's stages)
    print("timing " + json.dumps(dict(
        prepare_s=t1 - t0, load_model_s=t2 - t1, **res.timing)))
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        for k, v in res.metrics.items():
            f.write(f"{k} {v}\n")
    return res.metrics
