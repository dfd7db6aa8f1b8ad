"""The inference program: raw frames -> (R, t, success), on the device.

Port of `zebrapose_tpu/eval/evaluate.py::make_eval_step` (and
`_pad_to`): preprocess -> forward -> binarize -> surface-code decode ->
EPnP-RANSAC over a fixed batch, crops never leaving the device until
the final pose tensors. PyTorch runs it eagerly; the one hand-written
kernel on the path is the RANSAC hypothesis stage
(`ops/pnp_kernel.py`).

`run_inference`, `pose_errors`, `summarize` and `evaluate_object` need
the host dataset (cv2 PNG decode) and are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    reduce_lut_ignore_bits,
)
from zebrapose_tpu_torch.data.pipeline import preprocess_batch
from zebrapose_tpu_torch.ops.binarize import code_from_logits, mask_from_logits
from zebrapose_tpu_torch.ops.pnp import (
    PnPConfig,
    RansacDraws,
    decode_to_pose_batch,
)
from zebrapose_tpu_torch.utils.device import resolve_device


def _pad_to(arrs: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Zero-pad every array's leading axis to `size` (fixed batch)."""
    n = next(iter(arrs.values())).shape[0]
    if n == size:
        return arrs
    return {k: np.pad(v, [(0, size - n)] + [(0, 0)] * (v.ndim - 1))
            for k, v in arrs.items()}


def make_eval_step(forward_fn: Callable[[Dict[str, torch.Tensor]],
                                        Dict[str, torch.Tensor]],
                   lut: CorrespondenceLUT, crop_img: int, crop_gt: int,
                   base: int, n_bits: int, resize_method: str,
                   loss_type: str, pnp_cfg: PnPConfig,
                   ignore_bits: int = 0, return_masks: bool = False,
                   return_codes: bool = False,
                   mask_from_dataset: bool = False,
                   preprocess_gt: bool = True, device=None):
    """Build the batch program step(raw, final_bbox, K, generator=None,
    draws=None) -> (R [B,3,3], t [B,3], success [B], n_inliers [B])
    (+ (visible, entire) masks with return_masks, + codes with
    return_codes).

    forward_fn(batch) -> {"mask", "code", ...} logits (NHWC); for the
    model use `lambda b: model(b["image"])`, casting the image to the
    model's dtype for a bf16 model. Logits are taken to float32 before
    binarization. `raw` holds the arrays of `preprocess_batch` (numpy or
    tensors); everything is moved to `device` (CUDA unless "cpu" is
    asked for). RANSAC draws come from `draws` when given, else from
    `generator` (a torch.Generator on the device).
    """
    dev = resolve_device(device)
    if ignore_bits:
        lut = reduce_lut_ignore_bits(lut, ignore_bits)
    lut_points = torch.as_tensor(lut.points, device=dev)
    lut_valid = torch.as_tensor(lut.valid, device=dev)

    @torch.no_grad()
    def step(raw, final_bbox, K,
             generator: Optional[torch.Generator] = None,
             draws: Optional[RansacDraws] = None):
        raw = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        batch = preprocess_batch(
            raw, crop_img=crop_img, crop_gt=crop_gt, base=base,
            n_bits=n_bits, resize_method=resize_method,
            include_gt=preprocess_gt or mask_from_dataset)
        out = {k: v.float() for k, v in forward_fn(batch).items()}
        if mask_from_dataset:
            # the detector's mask replaces the network's mask head
            masks = (batch["mask"] > 0.5).to(torch.float32)
        else:
            masks = mask_from_logits(out["mask"][..., 0])
        codes = code_from_logits(out["code"], loss_type, base=base)
        if ignore_bits:
            codes = codes[..., :n_bits - ignore_bits]
        # `valid` zeroes dummy / detection-less samples
        poses = decode_to_pose_batch(
            masks * raw["valid"].to(torch.float32)[:, None, None], codes,
            lut_points, lut_valid, torch.as_tensor(final_bbox, device=dev),
            torch.as_tensor(K, device=dev, dtype=torch.float32),
            bbox_size=crop_gt, base=base,
            cfg=pnp_cfg, generator=generator, draws=draws, device=dev)
        extra = ()
        if return_masks:
            if mask_from_dataset:
                entire = (batch["entire_mask"] > 0.5).to(torch.float32)
            else:
                entire = mask_from_logits(
                    out.get("entire_mask", out["mask"])[..., 0])
            extra = (masks, entire)
        if return_codes:
            extra = extra + (codes,)
        return tuple(poses) + extra

    return step
