"""Debug visualization: the reference's --debug dumps (test.py:315-441).

Port of `zebrapose_tpu/utils/visualize.py` without cv2: per-image PNGs
of the predicted vs GT mask, per-bit code-error grids, and a pose
overlay (the mesh silhouette rendered under a pose by the host
rasterizer, its outline drawn on the input crop). The JAX package's
four cv2 calls have these counterparts, each giving cv2's pixels:

  * `cv2.resize` INTER_NEAREST: `resize_nearest`, the floor of the
    scaled index (`ops/roi.py::_cv2_nearest_coords` on the host);
  * `cv2.resize` INTER_LINEAR on uint8: `resize_linear`, cv2's
    fixed-point scheme (11-bit weights, the vertical pass as its SIMD
    code rounds it);
  * `cv2.findContours` (RETR_EXTERNAL, CHAIN_APPROX_NONE):
    `native.find_external_contours`;
  * `cv2.drawContours` at thickness 1: the contour pixels set to the
    color (consecutive CHAIN_APPROX_NONE points are 8-neighbours, so
    cv2's 8-connected lines between them are the points themselves);
  * `cv2.imwrite`: `data/png.py::imwrite` (other bytes, the same
    decoded pixels).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from zebrapose_tpu_torch.data import png

_COEF_SCALE = 2048          # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps(dst: int, src: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: (i0, i1, w0, w1) with
    the fixed-point weights. The horizontal axis clamps its offsets and
    weights at the borders (`clamp`); the vertical one keeps the weights
    and clamps only the rows it reads."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low], s[high] = 0, src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)
                 ).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=INTER_LINEAR)` of a
    uint8 [H, W] or [H, W, C] image, pixel for pixel: int32 rows of
    weighted sums (11-bit weights), then each output row from two of
    them as cv2's vector code rounds it, ((r0 >> 4) * b0 >> 16) +
    ((r1 >> 4) * b1 >> 16), + 2 >> 2. A [H, W, 1] input gives
    [size, size], as cv2 does."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(size, w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(size, h, clamp=False)
    cols = (slice(None),) + (None,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[cols] + src[:, x1] * a1[cols]
    b0 = b0.reshape((-1,) + (1,) * (rows.ndim - 1))
    b1 = b1.reshape(b0.shape)
    out = ((((rows[y0] >> 4) * b0) >> 16)
           + (((rows[y1] >> 4) * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=INTER_NEAREST)`:
    source index floor(d * src / size), at most src - 1."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]

    def idx(src):
        s = np.floor(np.arange(size, dtype=np.float64)
                     * (1.0 / (np.float64(size) / np.float64(src))))
        return np.minimum(s.astype(np.int64), src - 1)

    return img[idx(h)[:, None], idx(w)[None, :]]


def host_crop(img: np.ndarray, final_bbox, size: int,
              nearest: bool = False) -> np.ndarray:
    """Crop the final-bbox region (zero-padded outside the image) and
    resize it to `size`: a host-side stand-in for the device crop, for
    debug artifacts (the crops the network sees come from `ops/roi.py`
    on the device)."""
    x, y, w, h = (int(v) for v in final_bbox[:4])
    w, h = max(w, 1), max(h, 1)
    H, W = img.shape[:2]
    canvas = np.zeros((h, w) + img.shape[2:], img.dtype)
    sx0, sy0 = max(x, 0), max(y, 0)
    sx1, sy1 = min(x + w, W), min(y + h, H)
    if sx1 > sx0 and sy1 > sy0:
        canvas[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = img[sy0:sy1, sx0:sx1]
    return (resize_nearest if nearest else resize_linear)(canvas, size)


def draw_contours(img: np.ndarray, contours, color) -> np.ndarray:
    """`cv2.drawContours(img, contours, -1, color, 1)` for
    CHAIN_APPROX_NONE contours ([n, 2] (x, y) arrays), in place."""
    for c in contours:
        c = np.asarray(c).reshape(-1, 2)
        img[c[:, 1], c[:, 0]] = color
    return img


def save_mask_panel(path: str, pred_mask: np.ndarray,
                    gt_mask: Optional[np.ndarray] = None) -> None:
    """Side-by-side mask comparison (u8 panel)."""
    panels = [np.clip(pred_mask * 255, 0, 255).astype(np.uint8)]
    if gt_mask is not None:
        panels.append(np.clip(gt_mask * 255, 0, 255).astype(np.uint8))
        panels.append((np.abs(pred_mask - gt_mask) * 255).astype(np.uint8))
    png.imwrite(path, np.concatenate(panels, axis=1))


def save_code_grid(path: str, pred_code: np.ndarray,
                   gt_code: Optional[np.ndarray] = None,
                   cols: int = 4) -> None:
    """Grid of bit planes; with GT, green = correct bit, red = wrong."""
    h, w, n = pred_code.shape
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for b in range(n):
        r, c = divmod(b, cols)
        cell = grid[r * h:(r + 1) * h, c * w:(c + 1) * w]
        if gt_code is None:
            cell[..., :] = (pred_code[..., b, None] * 255).astype(np.uint8)
        else:
            ok = pred_code[..., b] == gt_code[..., b]
            cell[..., 1] = np.where(ok, 200, 0)
            cell[..., 2] = np.where(~ok, 200, 0)
    png.imwrite(path, grid)


def save_pose_overlay(path: str, crop_bgr: np.ndarray,
                      mesh_pts: np.ndarray, mesh_faces: np.ndarray,
                      K: np.ndarray, R: np.ndarray, t: np.ndarray,
                      final_bbox: np.ndarray, crop_size: int,
                      color=(0, 255, 0)) -> None:
    """Outline the mesh silhouette under (R, t) on the crop: the mesh is
    rendered with intrinsics that make the final bbox fill the
    crop_size² target, and the silhouette's outer border is drawn."""
    from zebrapose_tpu_torch import native

    h = w = crop_size
    sx = crop_size / max(float(final_bbox[2]), 1.0)
    sy = crop_size / max(float(final_bbox[3]), 1.0)
    Kc = np.array(K, np.float64).copy()
    Kc[0, 0] *= sx
    Kc[1, 1] *= sy
    Kc[0, 2] = (K[0, 2] - float(final_bbox[0])) * sx
    Kc[1, 2] = (K[1, 2] - float(final_bbox[1])) * sy
    ids, _ = native.render_label(
        mesh_pts.astype(np.float32), mesh_faces.astype(np.int32),
        np.ones(len(mesh_faces), np.int32), Kc, np.asarray(R, np.float64),
        np.asarray(t, np.float64).reshape(3), w, h)
    img = np.ascontiguousarray(crop_bgr.astype(np.uint8))
    draw_contours(img, native.find_external_contours(ids > 0), color)
    png.imwrite(path, img)


def dump_debug_sample(out_dir: str, index: int, crop_bgr, pred_mask,
                      gt_mask, pred_code, gt_code, mesh_pts, mesh_faces,
                      K, R_pred, t_pred, final_bbox,
                      R_gt=None, t_gt=None,
                      render_pred: bool = True) -> None:
    """One sample's debug dump: `<index>_mask.png`, `_code_err.png`,
    and the pose overlays `_pose.png` / `_pose_gt.png`, which are
    skipped when the mesh has no faces (a point-cloud PLY), the
    predicted one also when the pose is a failure placeholder
    (render_pred=False)."""
    os.makedirs(out_dir, exist_ok=True)

    def p(name):
        return os.path.join(out_dir, f"{index:06d}_{name}.png")

    save_mask_panel(p("mask"), pred_mask, gt_mask)
    save_code_grid(p("code_err"), pred_code, gt_code)
    if mesh_faces is None or len(mesh_faces) == 0:
        return
    if render_pred:
        save_pose_overlay(p("pose"), crop_bgr, mesh_pts, mesh_faces, K,
                          R_pred, t_pred, final_bbox, crop_bgr.shape[0])
    if R_gt is not None:
        save_pose_overlay(p("pose_gt"), crop_bgr, mesh_pts, mesh_faces,
                          K, R_gt, t_gt, final_bbox, crop_bgr.shape[0],
                          color=(255, 0, 0))
