"""Frozen copy of the port's crop: `data/pipeline.py::preprocess_batch`
(square crop + resize on the device, the training augmentation, ImageNet
normalization, label -> code planes) and `gather_preprocess_batch` (a
training batch gathered from uint8 frames by index), for the benchmark's
plain reference."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .augment import AugmentDraws, augment_batch, draw_augment
from .roi import extract_roi_affine, extract_roi_clipped, extract_roi_square
from .surface_code import class_id_to_code, rgb_to_class_id
from .zebra_net import normalize_image

PIXEL_KEYS = ("rgb", "label", "mask", "entire_mask")

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
                     include_gt: bool = True, is_train: bool = False,
                     use_pepper_salt: bool = False,
                     use_motion_blur: bool = False,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[AugmentDraws] = None
                     ) -> Dict[str, torch.Tensor]:
    """raw: {"rgb" [N,H,W,3] u8 BGR, "label" [N,H,W,3] u8, "mask"
    [N,H,W] u8, "entire_mask" [N,H,W] u8, "roi_param" ([N,5] int square
    | [N,4] int clipped | [N,3] f32 affine), "valid" [N] f32}, tensors
    on one device.

    Returns {"image" [N,crop_img,crop_img,3]} and, with include_gt, also
    "mask", "entire_mask" [N,crop_gt,crop_gt] and "code"
    [N,crop_gt,crop_gt,n_bits]. The u8 pixels are gathered as they are
    and widened by the interpolation weights (same values as widening
    first). is_train augments the f32 crop before normalization with
    `draws`, or with values drawn from `generator` (a torch.Generator
    on the batch's device).
    """
    p = raw["roi_param"]
    roi_rgb = _roi(raw["rgb"], p, crop_img, resize_method, "linear")
    if is_train:
        if draws is None:
            if generator is None:
                raise ValueError("a training batch needs a generator or "
                                 "injected draws")
            draws = draw_augment(generator, roi_rgb.shape[0], crop_img,
                                 crop_img, use_pepper_salt, use_motion_blur)
        roi_rgb = augment_batch(roi_rgb, draws)
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



def gather_preprocess_batch(cache_arrays: Dict[str, torch.Tensor],
                            idx: torch.Tensor, roi_param: torch.Tensor,
                            valid: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            crop_img: int = 256, crop_gt: int = 128,
                            base: int = 2, n_bits: int = 16,
                            resize_method: str = "crop_square_resize",
                            use_pepper_salt: bool = False,
                            use_motion_blur: bool = False,
                            draws: Optional[AugmentDraws] = None
                            ) -> Dict[str, torch.Tensor]:
    """A training batch from a DeviceDatasetCache's arrays: the drawn
    samples gathered on the device (`index_select`, still uint8), then
    `preprocess_batch(is_train=True)` with `generator` (or `draws`).
    `idx`, `roi_param` and `valid` are moved to the arrays' device."""
    dev = cache_arrays["rgb"].device
    idx = torch.as_tensor(idx).to(dev, torch.int64)
    raw = {k: torch.index_select(cache_arrays[k], 0, idx)
           for k in PIXEL_KEYS}
    raw["roi_param"] = torch.as_tensor(roi_param).to(dev)
    raw["valid"] = torch.as_tensor(valid).to(dev)
    return preprocess_batch(
        raw, crop_img=crop_img, crop_gt=crop_gt, base=base, n_bits=n_bits,
        resize_method=resize_method, is_train=True,
        use_pepper_salt=use_pepper_salt, use_motion_blur=use_motion_blur,
        generator=generator, draws=draws)
