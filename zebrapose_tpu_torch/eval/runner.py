"""Test-run orchestration: the reference test.py main.

Port of `zebrapose_tpu/eval/runner.py` (`load_model_variables`,
`extract_visible_contour`, `refine_poses`, `dataset_image_hw`,
`ObjectEval`, `prepare_object_eval`, `dump_debug_set`, `run_test`).
Assembles dataset + detections + LUT + model + eval program from a
ZebraConfig and runs the evaluation on the device (CUDA unless "cpu" is
asked for), with the optional contour refinement pass on the host
(`cfg.refine`: the native border follower and Gauss-Newton refiner,
`native/`) and the `debug` dumps (`utils/visualize.py`).

`int8` runs the int8 serving convs (`models/layers.py`, the kernels of
`ops/int8_conv.py` on the card). Orbax checkpoint directories are
refused by design: convert one with the JAX package's `export-ckpt`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from zebrapose_tpu_torch import native
from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data import bop_io, png
from zebrapose_tpu_torch.data import detections as det_mod
from zebrapose_tpu_torch.data.bop_writer import parse_sample_ids, write_csv
from zebrapose_tpu_torch.data.dataset_info import is_symmetric, lookup_obj_id
from zebrapose_tpu_torch.data.pipeline import CropDatasetHost
from zebrapose_tpu_torch.eval.evaluate import (
    evaluate_object,
    make_eval_step,
    pose_errors,
    run_inference,
    summarize,
)
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.ops.roi import map_pixels_to_original
from zebrapose_tpu_torch.utils.device import resolve_device


def load_model_variables(ckpt_file: str, variant: str = "v2",
                         resnet_layers: int = 34,
                         nonbinary: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """A checkpoint's weights as a state dict of the port's ZebraPoseNet
    (whose names are the reference checkpoints' keys): a compact `.npz`
    (`utils/compact_ckpt.py`, converted by `models/convert.py` for the
    family `variant` / `resnet_layers` / `nonbinary`) or a
    reference-format `.pth` / `.pt` (`models/convert.py::
    reference_state_dict`: DDP prefixes stripped, absent skip-tap aliases
    filled)."""
    if ckpt_file.endswith(".npz"):
        from zebrapose_tpu_torch.models.convert import variables_to_state_dict
        from zebrapose_tpu_torch.utils.compact_ckpt import load_compact
        variables, _ = load_compact(ckpt_file)
        return variables_to_state_dict(variables, variant,
                                       nonbinary=nonbinary,
                                       resnet_layers=resnet_layers)
    if ckpt_file.endswith((".pth", ".pt")):
        from zebrapose_tpu_torch.models.convert import reference_state_dict
        ckpt = torch.load(ckpt_file, map_location="cpu", weights_only=True)
        return reference_state_dict(ckpt.get("model_state_dict", ckpt))
    raise NotImplementedError(
        f"checkpoint {ckpt_file!r}: orbax checkpoint directories are not "
        "read by the port (see ROADMAP.md); convert one with `python -m "
        "zebrapose_tpu export-ckpt` on a JAX host and pass the .pth, or "
        "pass a .npz")


def load_model(cfg: ZebraConfig, ckpt_file: str, variant: str = "v2",
               device=None, quant=False) -> ZebraPoseNet:
    """The config's ZebraPoseNet with the checkpoint's weights (strict),
    in eval mode on `device`, channels-last; `quant` its convs' int8
    mode (True: int8 serving)."""
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    dev = resolve_device(device)
    model = ZebraPoseNet(
        binary_code_length=cfg.number_of_itration,
        base=cfg.divide_number_each_itration, variant=variant,
        resnet_layers=cfg.resnet_layer,
        concat=cfg.concat_encoder_decoder,
        output_kernel_size=cfg.output_kernel_size, quant=quant)
    model.load_state_dict(load_model_variables(
        ckpt_file, variant, resnet_layers=cfg.resnet_layer,
        nonbinary=cfg.divide_number_each_itration != 2), strict=True)
    return model.eval().to(dev).to(memory_format=torch.channels_last)


def build_eval_step(cfg: ZebraConfig, model: ZebraPoseNet, lut,
                    pnp_cfg: PnPConfig, ignore_bit: int = 0,
                    mask_rcnn: bool = False, return_masks: bool = False,
                    return_codes: bool = False, device=None):
    """run_test's batch program for `model` (make_eval_step with the
    config's crop sizes, code and resize method); `return_masks` adds the
    (visible, entire) masks the refinement pass reads, `return_codes`
    the code bits of the debug dumps."""
    return make_eval_step(
        lambda b: model(b["image"]), lut,
        crop_img=cfg.BoundingBox_CropSize_image,
        crop_gt=cfg.BoundingBox_CropSize_GT,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=pnp_cfg,
        ignore_bits=ignore_bit, return_masks=return_masks,
        return_codes=return_codes, mask_from_dataset=mask_rcnn,
        preprocess_gt=False, device=device)


def extract_visible_contour(entire_mask: np.ndarray,
                            visible_mask: np.ndarray) -> np.ndarray:
    """Contour pixels of the entire mask whose 3x3 neighborhood holds
    visible-mask foreground (test.py:300-307), from the outer borders of
    the entire mask (`native.find_external_contours`, equal to
    cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)) with fewer than
    20 points dropped (edge_refine.cpp:83-90). Returns [N, 2] (x, y)
    int32."""
    vis = np.asarray(visible_mask) > 0.5
    h, w = vis.shape
    # a pixel's 3x3 neighborhood (clipped at the edges) holds foreground
    pad = np.pad(vis, 1)
    near = np.zeros_like(vis)
    for dy in range(3):
        for dx in range(3):
            near |= pad[dy:dy + h, dx:dx + w]
    pts = [c for c in native.find_external_contours(
        np.asarray(entire_mask) > 0.5) if len(c) >= 20]
    if not pts:
        return np.zeros((0, 2), np.int32)
    pts = np.concatenate(pts)
    return np.ascontiguousarray(pts[near[pts[:, 1], pts[:, 0]]], np.int32)


def refine_poses(dataset: CropDatasetHost, Rs, ts, ok, vis_masks,
                 ent_masks, mesh_pts, mesh_faces,
                 image_hw: Tuple[int, int], crop_gt: int,
                 iterations: int = 10,
                 debug_dir: Optional[str] = None) -> int:
    """In-place contour refinement of the successful poses (the
    reference's refine path): the crop-space visible contour is mapped to
    full-image pixels through the final bbox and the native Gauss-Newton
    refiner runs from the pose; a sample whose contour keeps fewer than
    20 pixels, or whose refiner stops (RuntimeError), keeps its pose.
    Returns how many poses were refined.

    The final bbox and K come from the dataset's parameters at
    `image_hw`, without reading the frame again (the JAX package reads
    it, `get_raw`, for the same values). debug_dir: a subdirectory of
    per-iteration images a sample (`native.edge_refine`)."""
    h_img, w_img = image_hw
    refined = 0
    for i in range(len(dataset)):
        if not ok[i]:
            continue
        contour = extract_visible_contour(ent_masks[i], vis_masks[i])
        if len(contour) < 20:
            continue
        params = dataset.get_params(i, (h_img, w_img))
        orig = map_pixels_to_original(
            torch.from_numpy(contour),
            torch.from_numpy(np.asarray(params["final_bbox"])),
            crop_gt).numpy()
        keep = (orig[:, 0] >= 0) & (orig[:, 0] < w_img) & \
               (orig[:, 1] >= 0) & (orig[:, 1] < h_img)
        orig = orig[keep]
        if len(orig) < 20:
            continue
        try:
            R2, t2 = native.edge_refine(
                mesh_pts, mesh_faces, params["K"].astype(np.float64),
                w_img, h_img, orig, Rs[i].astype(np.float64),
                ts[i].astype(np.float64), iterations=iterations,
                debug_dir=(os.path.join(debug_dir, f"{i:06d}")
                           if debug_dir else None))
        except RuntimeError:
            continue
        Rs[i] = R2.astype(np.float32)
        ts[i] = t2.astype(np.float32)
        refined += 1
    return refined


def dataset_image_hw(samples, dataset: CropDatasetHost) -> Tuple[int, int]:
    """(h, w) of the split's full images, for the refiner's clip bounds:
    the global camera file's im_size, else the size of the first image
    as read (tless primesense is 720x540; a 640x480 guess would drop
    right / bottom contour pixels)."""
    im_size = (samples.cam_param_global or {}).get("im_size")
    if im_size is None:
        img0 = png.imread(dataset.rgb_files[0])
        return img0.shape[0], img0.shape[1]
    return int(im_size[1]), int(im_size[0])


class ObjectEval:
    """Everything run_test needs per object."""

    def __init__(self, obj_id, dataset, scores, lut, mesh, vertices,
                 diameter, symmetric, samples):
        self.obj_id, self.dataset, self.scores = obj_id, dataset, scores
        self.lut, self.mesh = lut, mesh
        self.vertices, self.diameter = vertices, diameter
        self.symmetric, self.samples = symmetric, samples


def prepare_object_eval(cfg: ZebraConfig, obj_name: str,
                        max_samples: Optional[int] = None,
                        mask_rcnn: bool = False,
                        roi_slice: bool = False,
                        samples=None,
                        frame: Optional[tuple] = None) -> ObjectEval:
    """Assemble one object's eval inputs: BOP walk (+BOP-challenge
    targets), detection ingestion (+ycbv keyframes), dataset, LUT, mesh
    geometry (test.py:85-240 setup).

    samples: a walked split to share between objects (the walk does not
    depend on the object outside BOP-challenge mode, whose walk is
    rebuilt per object; the fleet walks once for its K objects).
    frame: (scene_id, im_id), the eval restricted to that one frame (the
    reference's test_for_one_image.py); ValueError when the walk does
    not hold it."""
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)

    if cfg.bop_challange:
        samples = bop_io.get_bop_challenge_test_data(
            cfg.bop_path, cfg.dataset_name, obj_id,
            data_folder=cfg.test_folder)
    elif samples is None:
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
    if frame is not None:
        ids = parse_sample_ids(lists[0])
        keep = [i for i, (s, im) in enumerate(ids)
                if (s, im) == (int(frame[0]), int(frame[1]))]
        if not keep:
            raise ValueError(
                f"frame scene={frame[0]} im={frame[1]} not found in "
                f"{cfg.test_folder} (object {obj_name}); "
                f"{len(ids)} frames walked")
        lists = [[lst[i] for i in keep] for lst in lists]
        if det_bboxes is not None:
            det_bboxes = [det_bboxes[i] for i in keep]
            scores = [scores[i] for i in keep]
        if det_segs is not None:
            det_segs = [det_segs[i] for i in keep]
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
        is_symmetric(cfg.dataset_name, obj_name), samples)


def dump_debug_set(dbg_dir: str, cfg: ZebraConfig, dataset: CropDatasetHost,
                   mesh, vertices, vis_masks, pred_codes, Rs, ts, ok,
                   max_samples: int = 16) -> None:
    """The debug artifact set of the first `max_samples` samples
    (reference test.py:315-441; JAX runner.py:261-296): the predicted /
    GT mask panel, the per-bit code-error grid, and the predicted and GT
    pose outlines on the crop (`utils/visualize.py::dump_debug_sample`).
    Shared by run_test --debug and run_test_fleet --debug (a
    subdirectory an object)."""
    from zebrapose_tpu_torch.codec.surface_code import (
        class_id_to_code,
        rgb_to_class_id,
    )
    from zebrapose_tpu_torch.utils.visualize import (
        dump_debug_sample,
        host_crop,
    )

    os.makedirs(dbg_dir, exist_ok=True)
    faces = mesh.get("faces")
    n_code_bits = pred_codes.shape[-1]
    sz = cfg.BoundingBox_CropSize_GT
    for i in range(min(len(dataset), max_samples)):
        raw = dataset.get_raw(i)
        fb = raw["final_bbox"]
        crop_bgr = host_crop(raw["rgb"], fb, sz)
        gt_mask = host_crop(raw["mask"], fb, sz,
                            nearest=True).astype(np.float32) / 255.0
        label_crop = host_crop(raw["label"], fb, sz, nearest=True)
        gt_code = class_id_to_code(
            rgb_to_class_id(torch.from_numpy(label_crop.astype(np.int32))),
            base=cfg.divide_number_each_itration,
            n_digits=cfg.number_of_itration).numpy()[..., :n_code_bits]
        has_gt = dataset.gts[i] is not None
        dump_debug_sample(
            dbg_dir, i, crop_bgr, vis_masks[i], gt_mask, pred_codes[i],
            gt_code, vertices,
            faces.astype(np.int32) if faces is not None else None,
            raw["K"].astype(np.float64), Rs[i], ts[i], fb,
            R_gt=raw["R"] if has_gt else None,
            t_gt=raw["t"] if has_gt else None,
            render_pred=bool(ok[i]))


def run_test(cfg: ZebraConfig, obj_name: str, ckpt_file: str,
             output_dir: str, ignore_bit: int = 0, variant: str = "v2",
             debug: bool = False, batch_size: int = 16,
             pnp_cfg: Optional[PnPConfig] = None,
             max_samples: Optional[int] = None,
             mask_rcnn: bool = False,
             int8: bool = False,
             roi_slice: bool = False,
             frame: Optional[tuple] = None,
             device=None) -> Dict[str, float]:
    """Single-instance evaluation of one object (test.py main): metrics,
    plus the BOP CSV (and without refinement or debug add_err.txt and
    ADD_result.txt) in `output_dir` and the metrics appended to its
    log.txt.

    cfg.refine: the contour refinement pass (test.py:276-313) runs on
    the host over the poses, the visible masks and the entire masks
    (`refine_poses`), then ADD / ADD-S and the CSV as the JAX package's
    refine branch writes them. debug: the same branch with the code
    bits too, the refiner's per-iteration frames under
    `<output_dir>/debug/refine`, then `dump_debug_set` at
    `<output_dir>/debug`; the poses and the CSV are those of the run
    without debug. frame: (scene, im), the one frame of `visualize`.
    mask_rcnn: the detector's RLE segmentation replaces the network's
    mask head (reference test_for_mask_rcnn.py), and refinement reads
    the dataset's entire mask. roi_slice: the host ships only each
    frame's clamped square-bbox bytes (bit-identical crops). int8: the
    int8 serving convs (same checkpoint; per-channel weight and dynamic
    per-tensor activation quantization, `models/layers.py::_int8_conv`)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    oe = prepare_object_eval(cfg, obj_name, max_samples=max_samples,
                             mask_rcnn=mask_rcnn, roi_slice=roi_slice,
                             frame=frame)
    t1 = time.perf_counter()
    model = load_model(cfg, ckpt_file, variant, device=dev, quant=int8)
    step = build_eval_step(cfg, model, oe.lut, pnp_cfg or PnPConfig(),
                           ignore_bit=ignore_bit, mask_rcnn=mask_rcnn,
                           return_masks=cfg.refine or debug,
                           return_codes=debug, device=dev)
    t2 = time.perf_counter()
    if cfg.refine or debug:
        metrics, timing = _masked_eval(cfg, oe, step, obj_name, output_dir,
                                       batch_size, dev, debug)
    else:
        res = evaluate_object(
            oe.dataset, step, oe.vertices, oe.diameter, oe.symmetric,
            oe.obj_id, cfg.dataset_name, obj_name, output_dir=output_dir,
            scores=oe.scores, batch_size=batch_size, device=dev)
        metrics, timing = res.metrics, res.timing
    # where this run's time went, in seconds (evaluate_object's stages,
    # or those of the refined / debug evaluation)
    print("timing " + json.dumps(dict(
        prepare_s=t1 - t0, load_model_s=t2 - t1, **timing)))
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        for k, v in metrics.items():
            f.write(f"{k} {v}\n")
    return metrics


def _masked_eval(cfg: ZebraConfig, oe: ObjectEval, step, obj_name: str,
                 output_dir: str, batch_size: int, dev, debug: bool):
    """run_test's refine / debug branch (JAX runner.py:344-391):
    inference with the masks (and with debug the codes), `refine_poses`
    over the successful samples when cfg.refine, failed samples set to
    identity and zero, ADD / ADD-S, the BOP CSV, then with debug the
    artifact set. Returns (metrics, seconds by stage, with `refined`,
    the count of refined poses, when cfg.refine)."""
    timing: Dict[str, float] = {}
    Rs, ts, ok, vis_masks, ent_masks, *codes = run_inference(
        oe.dataset, step, batch_size, device=dev, timing=timing,
        collect_masks=True, collect_codes=debug)
    dbg_dir = os.path.join(output_dir, "debug")
    if cfg.refine:
        t0 = time.perf_counter()
        refined = 0
        if "faces" in oe.mesh and len(oe.dataset) > 0:
            refined = refine_poses(
                oe.dataset, Rs, ts, ok, vis_masks, ent_masks, oe.vertices,
                oe.mesh["faces"].astype(np.int32),
                dataset_image_hw(oe.samples, oe.dataset),
                cfg.BoundingBox_CropSize_GT,
                debug_dir=os.path.join(dbg_dir, "refine") if debug else None)
        timing.update(refine_s=time.perf_counter() - t0, refined=refined)
    Rs[~ok] = np.eye(3)
    ts[~ok] = 0
    t0 = time.perf_counter()
    errors = pose_errors(oe.dataset, Rs, ts, ok, oe.vertices, oe.symmetric,
                         device=dev)
    metrics = summarize(errors, oe.diameter,
                        "ADD-S" if oe.symmetric else "ADD")
    timing["pose_errors_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(output_dir, exist_ok=True)
    ids = parse_sample_ids(oe.dataset.rgb_files)
    write_csv(os.path.join(output_dir, "pose_result_bop"),
              f"{cfg.dataset_name}_{obj_name}", oe.obj_id,
              [s for s, _ in ids], [i for _, i in ids], list(Rs),
              [t.reshape(3, 1) for t in ts],
              oe.scores if oe.scores is not None else [1.0] * len(ts))
    timing["write_s"] = time.perf_counter() - t0
    if debug:
        t0 = time.perf_counter()
        dump_debug_set(dbg_dir, cfg, oe.dataset, oe.mesh, oe.vertices,
                       vis_masks, codes[0], Rs, ts, ok)
        timing["debug_s"] = time.perf_counter() - t0
    return metrics, timing
