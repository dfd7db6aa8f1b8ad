"""Inference preprocessing on the device: raw frames -> model batch.

Port of the `is_train=False` branches of
`zebrapose_tpu/data/pipeline.py::preprocess_batch`: crop + resize (linear
for the BGR frame, nearest for GT label and masks), ImageNet
normalization, label RGB -> class id -> code planes. BGR channel order
is kept on purpose: the reference normalizes cv2's BGR frames with RGB
ImageNet statistics, and trained checkpoints expect exactly that.

The training branch (color augmentation, jittered bboxes) and the host
dataset (`CropDatasetHost`, which decodes PNGs with cv2) are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch

from zebrapose_tpu_torch.codec.surface_code import (
    class_id_to_code,
    rgb_to_class_id,
)
from zebrapose_tpu_torch.models.zebra_net import normalize_image
from zebrapose_tpu_torch.ops.roi import (
    extract_roi_affine,
    extract_roi_clipped,
    extract_roi_square,
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
