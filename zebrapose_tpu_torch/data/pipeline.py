"""Inference preprocessing on the device: raw frames -> model batch.

Port of the `is_train=False` branches of
`zebrapose_tpu/data/pipeline.py::preprocess_batch`: crop + resize (linear
for the BGR frame, nearest for GT label and masks), ImageNet
normalization, label RGB -> class id -> code planes. BGR channel order
is kept on purpose: the reference normalizes cv2's BGR frames with RGB
ImageNet statistics, and trained checkpoints expect exactly that.

The host dataset `CropDatasetHost` is the evaluation branch of its JAX
counterpart: byte I/O and integer bbox bookkeeping on the host, nothing
per-pixel, PNGs decoded by the port's own reader (`data/png.py`) where
the JAX package calls cv2. The training branch (color augmentation,
jittered bboxes, the batch iterators) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from zebrapose_tpu_torch.data import png

from zebrapose_tpu_torch.codec.surface_code import (
    class_id_to_code,
    rgb_to_class_id,
)
from zebrapose_tpu_torch.models.zebra_net import normalize_image
from zebrapose_tpu_torch.ops.roi import (
    extract_roi_affine,
    extract_roi_clipped,
    extract_roi_square,
    final_bbox,
    padding_bbox,
    square_bbox,
    warp_affine_params,
)

_ROI = {"crop_square_resize": extract_roi_square,
        "crop_resize": extract_roi_clipped,
        "crop_resize_by_warp_affine": extract_roi_affine}


def _roi(imgs, param, crop, method, interpolation):
    if method not in _ROI:
        raise NotImplementedError(method)
    return _ROI[method](imgs, param, crop, interpolation)


def preprocess_batch(raw: Dict[str, torch.Tensor], crop_img: int = 256,
                     crop_gt: int = 128, base: int = 2, n_bits: int = 16,
                     resize_method: str = "crop_square_resize",
                     include_gt: bool = True) -> Dict[str, torch.Tensor]:
    """raw: {"rgb" [N,H,W,3] u8 BGR, "label" [N,H,W,3] u8, "mask"
    [N,H,W] u8, "entire_mask" [N,H,W] u8, "roi_param" ([N,5] int square
    | [N,4] int clipped | [N,3] f32 affine), "valid" [N] f32}, tensors
    on one device.

    Returns {"image" [N,crop_img,crop_img,3]} and, with include_gt, also
    "mask", "entire_mask" [N,crop_gt,crop_gt] and "code"
    [N,crop_gt,crop_gt,n_bits]. The u8 pixels are gathered as they are
    and widened by the interpolation weights (same values as widening
    first).
    """
    p = raw["roi_param"]
    roi_rgb = _roi(raw["rgb"], p, crop_img, resize_method, "linear")
    image = normalize_image(roi_rgb / 255.0)
    valid = raw["valid"].to(torch.float32)[:, None, None]
    if not include_gt:
        return {"image": image * valid[..., None]}

    roi_label = _roi(raw["label"], p, crop_gt, resize_method, "nearest")
    ids = rgb_to_class_id(torch.round(roi_label).to(torch.int32))
    code = class_id_to_code(ids, base=base, n_digits=n_bits)

    def _mask_roi(m):
        r = _roi(m[..., None], p, crop_gt, resize_method, "nearest")
        return r[..., 0] / 255.0

    return {
        "image": image * valid[..., None],
        "mask": _mask_roi(raw["mask"]) * valid,
        "entire_mask": _mask_roi(raw["entire_mask"]) * valid,
        "code": code * valid[..., None],
    }


# ---------------------------------------------------------------------------
# Host dataset
# ---------------------------------------------------------------------------

class CropDatasetHost:
    """Host-side sample provider for one object, evaluation only.

    Port of the `is_train=False` contract of
    `zebrapose_tpu/data/pipeline.py::CropDatasetHost`: raw
    full-resolution arrays + bbox params per sample (the crop happens on
    the device), the same keys, dtypes and bytes. `gt_dir_suffix`
    selects `<split>_GT` (v1 labels) vs `<split>_GT_v2`.
    """

    def __init__(self, dataset_dir: str, data_folder: str,
                 rgb_files: Sequence[str],
                 mask_files: Sequence[Sequence[str]],
                 mask_visib_files: Sequence[Sequence[str]],
                 gts: Sequence[Optional[dict]],
                 gt_infos: Sequence[Optional[dict]],
                 cam_params: Sequence[dict],
                 is_train: bool = False,
                 crop_size_img: int = 256, crop_size_gt: int = 128,
                 padding_ratio: float = 1.5,
                 resize_method: str = "crop_square_resize",
                 gt_dir_suffix: str = "_GT_v2",
                 detect_bboxes: Optional[Sequence] = None,
                 detect_segmentations: Optional[Sequence] = None,
                 cache_images: bool = False,
                 roi_slice: bool = False):
        if is_train:
            raise NotImplementedError(
                "CropDatasetHost(is_train=True) is not ported yet (see "
                "ROADMAP.md, queue A: training)")
        self.dataset_dir = dataset_dir
        self.data_folder = data_folder
        self.rgb_files = list(rgb_files)
        self.mask_files = list(mask_files)
        self.mask_visib_files = list(mask_visib_files)
        self.gts = list(gts)
        self.gt_infos = list(gt_infos)
        self.cam_params = list(cam_params)
        self.is_train = False
        self.crop_size_img = crop_size_img
        self.crop_size_gt = crop_size_gt
        self.padding_ratio = padding_ratio
        self.resize_method = resize_method
        self.gt_dir_suffix = gt_dir_suffix
        self.detect_bboxes = detect_bboxes
        self.detect_segmentations = detect_segmentations
        # opt-in decoded-image RAM cache (~2.4 MB per 480x640 sample)
        self._cache: Optional[dict] = {} if cache_images else None
        self._cache_lock = threading.Lock()
        # opt-in: ship only each frame's clamped square-bbox bytes (see
        # _slice_roi)
        if roi_slice and resize_method != "crop_square_resize":
            raise NotImplementedError(
                "roi_slice supports crop_square_resize only")
        self.roi_slice = roi_slice
        self._slice_hw: Optional[tuple] = None

    def __len__(self):
        return len(self.rgb_files)

    def _imread(self, path: str, flags: int = png.IMREAD_COLOR):
        if self._cache is None:
            return png.imread(path, flags)
        key = (path, flags)
        with self._cache_lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        img = png.imread(path, flags)
        if img is not None:
            with self._cache_lock:
                self._cache[key] = img
        return img

    def _gt_label_path(self, idx: int) -> str:
        scene_id = self.rgb_files[idx].split("/")[-3]
        name = os.path.basename(self.mask_visib_files[idx][0])
        return os.path.join(self.dataset_dir,
                            self.data_folder + self.gt_dir_suffix,
                            scene_id, name)

    def _roi_param(self, bbox, im_shape):
        """Integer/float bbox bookkeeping -> device roi param + final
        bbox."""
        h, w = im_shape[:2]
        if self.resize_method == "crop_square_resize":
            x1, y1, x2, y2, side = square_bbox(bbox)
            param = np.array([x1, y1, x2, y2, max(side, 1)], np.int32)
        elif self.resize_method == "crop_resize":
            fb = final_bbox(bbox, "crop_resize", w, h)
            param = np.array([fb[0], fb[1], max(fb[2], 1),
                              max(fb[3], 1)], np.int32)
        else:  # crop_resize_by_warp_affine
            cx, cy, scale = warp_affine_params(bbox, (h, w))
            param = np.array([cx, cy, max(scale, 1e-3)], np.float32)
        fb = final_bbox(bbox, self.resize_method, w, h)
        return param, fb.astype(np.int64)

    def get_pixels(self, idx: int) -> Dict[str, np.ndarray]:
        """Per-sample pixel data: rgb, GT label, visible and entire
        masks."""
        rgb = self._imread(self.rgb_files[idx])
        if rgb is None:
            raise FileNotFoundError(self.rgb_files[idx])
        h, w = rgb.shape[:2]

        def _read_mask(path):
            m = self._imread(path, png.IMREAD_GRAYSCALE) \
                if path and os.path.exists(path) else None
            return m if m is not None else np.zeros((h, w), np.uint8)

        mask = _read_mask(self.mask_visib_files[idx][0])
        if (self.detect_segmentations is not None
                and self.detect_segmentations[idx] is not None):
            # Mask-RCNN variant: the detector's RLE replaces the visible
            # mask (bop_dataset_pytorch_mask_rcnn.py:270-287)
            from zebrapose_tpu_torch.data.detections import decode_rle
            mask = decode_rle(self.detect_segmentations[idx]) * 255
        entire = _read_mask(self.mask_files[idx][0])
        gt_path = self._gt_label_path(idx)
        # GT-less entries (vivo/challenge) have empty mask names, which
        # give a directory path here
        label = self._imread(gt_path) \
            if gt_path and os.path.isfile(gt_path) else None
        if label is None:
            label = np.zeros((h, w, 3), np.uint8)
        return {"rgb": rgb, "label": label, "mask": mask,
                "entire_mask": entire}

    def _eval_bbox(self, idx: int):
        """Deterministic test-time bbox (detection or GT) + padding, and
        the sample's validity (0 without a detection)."""
        valid = 1.0
        if self.detect_bboxes is not None:
            det = self.detect_bboxes[idx]
            if det is None:
                det = np.array([0, 0, 1, 1])
                valid = 0.0
            bbox = np.asarray(det)
        else:
            bbox = np.asarray(self.gt_infos[idx]["bbox_visib"])
        if np.all(np.isclose(bbox, -1)):
            bbox = np.array([0, 0, 1, 1])
            valid = 0.0
        return padding_bbox(bbox, self.padding_ratio), valid

    def get_params(self, idx: int,
                   im_shape: tuple) -> Dict[str, np.ndarray]:
        """Pose/K plus the bbox -> roi param + final bbox. No pixel
        access."""
        gt = self.gts[idx]
        if gt is not None:
            R = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
            t = np.asarray(gt["cam_t_m2c"], np.float64).reshape(3)
        else:
            R = np.eye(3)
            t = np.zeros(3)
        K = np.asarray(self.cam_params[idx]["cam_K"],
                       np.float64).reshape(3, 3)
        bbox, valid = self._eval_bbox(idx)
        param, fb = self._roi_param(bbox, im_shape)
        return {"roi_param": param, "final_bbox": fb,
                "R": R.astype(np.float32), "t": t.astype(np.float32),
                "K": K.astype(np.float32), "valid": np.float32(valid)}

    def _slice_buffer_hw(self, im_h: int, im_w: int):
        """Dataset-wide buffer dims for roi_slice: the max padded square
        side over every sample's eval bbox, rounded up to a multiple of
        16 and capped at the frame dims (one shape per run). Frames of
        differing sizes within one dataset are rejected."""
        if self._slice_hw is not None:
            hw, cap = self._slice_hw
            if cap != (im_h, im_w):
                raise ValueError(
                    f"roi_slice: mixed frame sizes in one dataset "
                    f"({cap} vs {(im_h, im_w)})")
            return hw
        max_side = 1
        for i in range(len(self)):
            bbox, _ = self._eval_bbox(i)
            max_side = max(max_side, int(square_bbox(bbox)[4]))
        side = -(-max_side // 16) * 16
        hw = (min(side, im_h), min(side, im_w))
        self._slice_hw = (hw, (im_h, im_w))
        return hw

    def _slice_roi(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Byte-slice the clamped square-bbox region of every pixel array
        into the zero-padded dataset buffer and shift roi_param by the
        slice origin. The device crop is bit-identical to the full-frame
        one: real pixels keep their tap coordinates relative to the
        shifted param, and every tap outside the slice reads zeros or is
        killed by the validity gate, as outside the frame."""
        im_h, im_w = out["rgb"].shape[:2]
        bh, bw = self._slice_buffer_hw(im_h, im_w)
        p = out["roi_param"]
        x1, y1, x2, y2 = int(p[0]), int(p[1]), int(p[2]), int(p[3])
        xs, ys = max(x1, 0), max(y1, 0)
        xe, ye = max(min(x2, im_w), xs), max(min(y2, im_h), ys)
        # a square larger than the frame: copy what fits the buffer (the
        # rest reads as zero, as the full-frame validity gate gives)
        ye, xe = min(ye, ys + bh), min(xe, xs + bw)
        for k in ("rgb", "label", "mask", "entire_mask"):
            buf = np.zeros((bh, bw) + out[k].shape[2:], out[k].dtype)
            buf[:ye - ys, :xe - xs] = out[k][ys:ye, xs:xe]
            out[k] = buf
        out["roi_param"] = p - np.array([xs, ys, xs, ys, 0], p.dtype)
        return out

    def get_raw(self, idx: int) -> Dict[str, np.ndarray]:
        px = self.get_pixels(idx)
        out = dict(px)
        out.update(self.get_params(idx, px["rgb"].shape))
        if self.roi_slice:
            out = self._slice_roi(out)
        return out

    def collate(self, indices: Sequence[int],
                executor=None) -> Dict[str, np.ndarray]:
        """Stack the samples' raw dicts; `executor` (a thread pool) reads
        them in parallel."""
        if executor is not None:
            rows = list(executor.map(self.get_raw, indices))
        else:
            rows = [self.get_raw(i) for i in indices]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
