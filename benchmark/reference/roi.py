"""ROI geometry: host bbox bookkeeping + batched crop/resize on the device.

Port of `zebrapose_tpu/ops/roi.py`. The integer bbox math stays on the
host with the reference's C-style truncation; the per-pixel crop runs
on the device, batched over (image, bbox) pairs.

JAX expresses each crop as two interpolation-matrix matmuls (gathers
are slow on the TPU). Here the same taps are gathered directly: each
output pixel is Σ_a Σ_b wy_a · wx_b · img[iy_a, ix_b] over the two (or,
for nearest, one) taps per axis, in float32 without any matmul, so no
TF32 rounding can enter. Tap coordinates, weights and validity follow
the JAX functions exactly (cv2.resize: linear src = (dst+0.5)·scale-0.5
with edge replication inside the square, nearest src = floor(dst·scale);
warpAffine: src = center - scale/2 + dst·scale/crop, constant-0 border).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side integer bbox bookkeeping (exact reference semantics)
# ---------------------------------------------------------------------------


def _trunc(v) -> int:
    """C-style int cast (truncate toward zero), like Python int()."""
    return int(v)


def padding_bbox(bbox, padding_ratio: float) -> np.ndarray:
    """Scale a (x, y, w, h) bbox about its center."""
    x1, y1, bw, bh = (float(v) for v in bbox)
    cx = x1 + 0.5 * bw
    cy = y1 + 0.5 * bh
    pw = _trunc(bw * padding_ratio)
    ph = _trunc(bh * padding_ratio)
    return np.array([_trunc(cx - pw / 2), _trunc(cy - ph / 2), pw, ph],
                    dtype=np.int64)


def augment_bbox(bbox, padding_ratio: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Random scale in [0.75, 1.25] + center shift of ±0.25 w/h, then
    pad."""
    x1, y1, bw, bh = (float(v) for v in bbox)
    cx = x1 + 0.5 * bw
    cy = y1 + 0.5 * bh
    scale_ratio = 1 + 0.25 * (2 * rng.random() - 1)
    shift = 0.25 * (2 * rng.random(2) - 1)
    cx = cx + bw * shift[0]
    cy = cy + bh * shift[1]
    aw = _trunc(bw * scale_ratio * padding_ratio)
    ah = _trunc(bh * scale_ratio * padding_ratio)
    return np.array([_trunc(cx - aw / 2), _trunc(cy - ah / 2), aw, ah],
                    dtype=np.int64)


def square_bbox(bbox) -> Tuple[int, int, int, int, int]:
    """Expand (x, y, w, h) to the crop square: (x1, y1, x2, y2, side),
    side = max(w, h), the shorter axis re-centered then truncated."""
    x1, y1, bw, bh = (float(v) for v in bbox)
    bw = max(bw, 0.0)
    bh = max(bh, 0.0)
    x2 = x1 + bw
    y2 = y1 + bh
    cx = 0.5 * (x1 + x2)
    cy = 0.5 * (y1 + y2)
    if bh > bw:
        x1 = cx - bh / 2
        x2 = cx + bh / 2
    else:
        y1 = cy - bw / 2
        y2 = cy + bw / 2
    return (_trunc(x1), _trunc(y1), _trunc(x2), _trunc(y2),
            int(max(bh, bw)))


def final_bbox(bbox, resize_method: str, max_x: int, max_y: int
               ) -> np.ndarray:
    """The bbox the crop represents, for mapping crop pixels back to
    the frame. max_x / max_y are image width / height."""
    if resize_method in ("crop_square_resize", "crop_resize_by_warp_affine"):
        x1, y1, x2, y2, _ = square_bbox(bbox)
        return np.array([x1, y1, x2 - x1, y2 - y1], dtype=np.int64)
    if resize_method == "crop_resize":
        x1 = _trunc(max(float(bbox[0]), 0))
        y1 = _trunc(max(float(bbox[1]), 0))
        x2 = _trunc(min(float(bbox[0]) + float(bbox[2]), max_x))
        y2 = _trunc(min(float(bbox[1]) + float(bbox[3]), max_y))
        return np.array([x1, y1, x2 - x1, y2 - y1], dtype=np.int64)
    raise NotImplementedError(f"unknown resize_method: {resize_method}")


def warp_affine_params(bbox, image_hw: Tuple[int, int]
                       ) -> Tuple[float, float, float]:
    """(cx, cy, scale) for the CenterNet-style affine crop:
    scale = min(max(bw, bh), max(H, W))."""
    x1, y1, bw, bh = (float(v) for v in bbox)
    cx = x1 + 0.5 * bw
    cy = y1 + 0.5 * bh
    scale = min(max(bh, bw), max(image_hw[0], image_hw[1])) * 1.0
    return cx, cy, scale


# ---------------------------------------------------------------------------
# Device-side sampling, batched: a tap is (index [B, crop] int64,
# weight [B, crop] f32, valid [B, crop] bool)
# ---------------------------------------------------------------------------

Tap = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _arange(crop: int, device) -> torch.Tensor:
    return torch.arange(crop, dtype=torch.float32, device=device)[None, :]


def _cv2_linear_coords(crop: int, side: torch.Tensor):
    """cv2 INTER_LINEAR source coords + lerp weights inside a `side`
    square; side [B] float32."""
    side = side[:, None]
    scale = side / crop
    s = (_arange(crop, side.device) + 0.5) * scale - 0.5
    s = torch.minimum(torch.clamp_min(s, 0.0), side - 1.0)
    i0 = torch.floor(s)
    return i0.to(torch.int64), s - i0


def _cv2_nearest_coords(crop: int, side: torch.Tensor) -> torch.Tensor:
    """cv2 INTER_NEAREST source coords inside a `side` square."""
    side = side[:, None]
    s = torch.floor(_arange(crop, side.device) * (side / crop))
    return torch.minimum(torch.clamp_min(s, 0), side - 1).to(torch.int64)


def _gather_taps(img: torch.Tensor, ytaps: List[Tap],
                 xtaps: List[Tap]) -> torch.Tensor:
    """img [B, H, W, C] -> [B, crop, crop, C]: Σ over tap pairs of
    wy · wx · img[iy, ix], taps outside the image or not valid reading
    zero (what the JAX interpolation matrices do)."""
    B, h, w = img.shape[:3]
    bidx = torch.arange(B, device=img.device)[:, None, None]
    out = None
    for iy, wy, vy in ytaps:
        vy = vy & (iy >= 0) & (iy < h)
        wy = wy * vy
        iy = iy.clamp(0, h - 1)
        row = None
        for ix, wx, vx in xtaps:
            vx = vx & (ix >= 0) & (ix < w)
            wx = wx * vx
            ix = ix.clamp(0, w - 1)
            term = img[bidx, iy[:, :, None], ix[:, None, :]] * \
                wx[:, None, :, None]
            row = term if row is None else row + term
        term = row * wy[:, :, None, None]
        out = term if out is None else out + term
    return out


def extract_roi_square(img: torch.Tensor, sq_bbox: torch.Tensor,
                       crop_size: int,
                       interpolation: str = "linear") -> torch.Tensor:
    """crop_square_resize: img [B, H, W, C] float32, sq_bbox int[B, 5] =
    (x1, y1, x2, y2, side) from `square_bbox` -> [B, crop, crop, C].
    Square pixels outside the image or beyond x2/y2 read as zero;
    resampling replicates at the square edge."""
    h, w = img.shape[1], img.shape[2]
    p = sq_bbox.to(torch.int64)
    x1, y1, x2, y2, side_i = (p[:, i:i + 1] for i in range(5))
    side = p[:, 4].to(torch.float32)

    def taps(axis_size, lo, hi_clip) -> List[Tap]:
        hi = torch.clamp_max(hi_clip, axis_size)
        if interpolation == "nearest":
            idx = lo + _cv2_nearest_coords(crop_size, side)
            return [(idx, torch.ones_like(idx, dtype=torch.float32),
                     (idx >= 0) & (idx < hi))]
        i0, f = _cv2_linear_coords(crop_size, side)
        i1 = torch.minimum(i0 + 1, side_i - 1)
        out = []
        for s, wgt in ((i0, 1.0 - f), (i1, f)):
            idx = lo + s
            out.append((idx, wgt, (idx >= 0) & (idx < hi)))
        return out

    return _gather_taps(img, taps(h, y1, y2), taps(w, x1, x2))


def extract_roi_clipped(img: torch.Tensor, clip_bbox: torch.Tensor,
                        crop_size: int,
                        interpolation: str = "linear") -> torch.Tensor:
    """crop_resize: resample the image-clipped (x1, y1, w, h) bbox
    (int[B, 4] from `final_bbox(..., "crop_resize", ...)`), replicating
    at its edges."""
    p = clip_bbox.to(torch.int64)
    x1, y1, bw, bh = (p[:, i:i + 1] for i in range(4))

    def taps(lo, extent) -> List[Tap]:
        ext_f = extent[:, 0].to(torch.float32)
        if interpolation == "nearest":
            idx = lo + _cv2_nearest_coords(crop_size, ext_f)
            return [(idx, torch.ones_like(idx, dtype=torch.float32),
                     torch.ones_like(idx, dtype=torch.bool))]
        i0, f = _cv2_linear_coords(crop_size, ext_f)
        i1 = torch.minimum(i0 + 1, extent - 1)
        true = torch.ones_like(i0, dtype=torch.bool)
        return [(lo + i0, 1.0 - f, true), (lo + i1, f, true)]

    return _gather_taps(img, taps(y1, bh), taps(x1, bw))


def extract_roi_affine(img: torch.Tensor, center_scale: torch.Tensor,
                       crop_size: int,
                       interpolation: str = "linear") -> torch.Tensor:
    """crop_resize_by_warp_affine (rot = 0): center_scale float32[B, 3] =
    (cx, cy, scale) from `warp_affine_params`; the side-`scale` square
    about (cx, cy) maps onto the crop, constant-0 border."""
    cs = center_scale.to(torch.float32)
    cx, cy, scale = (cs[:, i:i + 1] for i in range(3))
    step = scale / crop_size
    u = _arange(crop_size, img.device)

    def taps(center) -> List[Tap]:
        s = center - scale / 2 + u * step
        if interpolation == "nearest":
            idx = torch.round(s).to(torch.int64)
            return [(idx, torch.ones_like(s),
                     torch.ones_like(idx, dtype=torch.bool))]
        i0f = torch.floor(s)
        f = s - i0f
        i0 = i0f.to(torch.int64)
        true = torch.ones_like(i0, dtype=torch.bool)
        return [(i0, 1.0 - f, true), (i0 + 1, f, true)]

    return _gather_taps(img, taps(cy), taps(cx))


def map_pixels_to_original(pixels_xy: torch.Tensor, bbox: torch.Tensor,
                           bbox_size: int) -> torch.Tensor:
    """Crop-pixel (x, y) -> full-image integer pixel coordinates, with
    the reference's int truncation. bbox is the final (x, y, w, h)."""
    ratio = bbox[..., 2:4].to(torch.float32) / bbox_size
    orig = ratio * pixels_xy.to(torch.float32) + bbox[..., 0:2].to(
        torch.float32)
    return orig.to(torch.int32)          # truncates toward zero
