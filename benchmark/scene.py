"""The traffic's scene, made on the device from a seed: 480x640 BGR
frames of the rehearsal object (a radius-40 mm sphere whose color codes
its surface position; the object the committed checkpoint was trained
on), its masks, its 16-bit surface-code labels and its detections.

The geometry is the benchmark's own copy of `chip_smoke.py`'s
`pixel_rays`, `sphere_hits`, `sphere_surface` and `sphere_frame`
(:647-690), batched in torch: a random rotation (QR of a normal matrix,
sign-fixed), t in [-40, 40] x [-30, 30] x [480, 650] mm, color
(p / 40 * 0.5 + 0.5) * 255 over uniform background bytes, N(0, 6)
pixel noise. A labelled pixel's class is the nearest valid centroid of
the committed LUT, as `chip_smoke.py::write_train_split` labels it
(:870-920). The bbox arithmetic is the port's `square_bbox` /
`padding_bbox` / `augment_bbox`, vectorised over rows."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

K_LMO = np.array([[572.4114, 0, 325.2611],
                  [0, 573.57043, 242.04899],
                  [0, 0, 1]], np.float32)
RADIUS = 40.0
IMAGE_HW = (480, 640)


def pixel_rays(device) -> torch.Tensor:
    """[480 * 640, 3] rays K^-1 (x, y, 1) of every pixel, row-major."""
    h, w = IMAGE_HW
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    kinv = torch.linalg.inv(torch.from_numpy(K_LMO.astype(np.float64)))
    return (pix @ kinv.T).to(device=device, dtype=torch.float32)


def _rotations(gen: torch.Generator, n: int, device) -> torch.Tensor:
    q, r = torch.linalg.qr(torch.randn((n, 3, 3), generator=gen,
                                       device=device))
    # Q of numpy's QR: R's diagonal may be negative; any proper rotation
    # drawn this way serves
    q = q * torch.sign(torch.linalg.det(q))[:, None, None]
    return q


def render(gen: torch.Generator, n: int, device, labels: bool = False,
           lut_points: Optional[torch.Tensor] = None,
           lut_valid: Optional[torch.Tensor] = None,
           chunk: int = 32) -> Dict[str, torch.Tensor]:
    """n frames on `device`: rgb [n, 480, 640, 3] u8, mask [n, 480, 640]
    u8 (255 on the object; the sphere is never occluded, so the visible
    and the entire mask agree), bbox [n, 4] int64 (x, y, w, h of the
    mask), R [n, 3, 3], t [n, 3]; with `labels`, label [n, 480, 640, 3]
    u8 (the nearest valid LUT centroid's class id in BGR bytes)."""
    h, w = IMAGE_HW
    rays = pixel_rays(device)
    rr = (rays * rays).sum(-1)
    R = _rotations(gen, n, device)
    u = torch.rand((n, 3), generator=gen, device=device)
    t = torch.stack([-40 + 80 * u[:, 0], -30 + 60 * u[:, 1],
                     480 + 170 * u[:, 2]], -1)
    out = {"rgb": torch.empty((n, h, w, 3), dtype=torch.uint8, device=device),
           "mask": torch.empty((n, h, w), dtype=torch.uint8, device=device),
           "bbox": torch.empty((n, 4), dtype=torch.int64, device=device),
           "R": R, "t": t}
    if labels:
        out["label"] = torch.zeros((n, h, w, 3), dtype=torch.uint8,
                                   device=device)
        ids = torch.nonzero(lut_valid).reshape(-1)
        cent = lut_points[ids].to(torch.float32)
        cent_sq = (cent * cent).sum(-1)
    xs = torch.arange(w, device=device).repeat(h)
    ys = torch.arange(h, device=device).repeat_interleave(w)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        tc, Rc = t[s:e], R[s:e]
        dt = rays @ tc.T                                       # [P, c]
        disc = dt * dt - rr[:, None] * ((tc * tc).sum(-1)
                                        - RADIUS ** 2)[None]
        hit = (disc >= 0).T                                    # [c, P]
        depth = ((dt - torch.sqrt(torch.clamp_min(disc, 0))) / rr[:, None]).T
        pm = torch.einsum("cpk,ckj->cpj",
                          depth[..., None] * rays[None] - tc[:, None],
                          Rc)                                  # model frame
        color = (pm / RADIUS * 0.5 + 0.5) * 255
        bg = torch.randint(0, 255, color.shape, generator=gen,
                           device=device, dtype=torch.int32).float()
        noise = torch.randn(color.shape, generator=gen, device=device) * 6
        img = torch.where(hit[..., None], color, bg) + noise
        out["rgb"][s:e] = torch.clamp(img, 0, 255).to(torch.uint8).reshape(
            e - s, h, w, 3)
        out["mask"][s:e] = (hit.to(torch.uint8) * 255).reshape(e - s, h, w)
        big = torch.iinfo(torch.int64).max
        x0 = torch.where(hit, xs, big).amin(-1)
        y0 = torch.where(hit, ys, big).amin(-1)
        x1 = torch.where(hit, xs, -1).amax(-1)
        y1 = torch.where(hit, ys, -1).amax(-1)
        out["bbox"][s:e] = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], -1)
        if labels:
            fi, pi = torch.nonzero(hit, as_tuple=True)
            pts = pm[fi, pi]
            cls = torch.empty(pts.shape[0], dtype=torch.int64, device=device)
            for a in range(0, pts.shape[0], 4096):
                d = cent_sq[None] - 2 * pts[a:a + 4096] @ cent.T
                cls[a:a + 4096] = ids[d.argmin(-1)]
            bgr = torch.stack([(cls >> 16) & 255, (cls >> 8) & 255,
                               cls & 255], -1).to(torch.uint8)
            out["label"].view(n, h * w, 3)[s + fi, pi] = bgr
    return out


def _trunc(v: np.ndarray) -> np.ndarray:
    return np.trunc(v).astype(np.int64)


def padding_bbox(bbox: np.ndarray, ratio: float) -> np.ndarray:
    """[n, 4] (x, y, w, h) scaled about the center (int truncation)."""
    b = bbox.astype(np.float64)
    cx, cy = b[:, 0] + 0.5 * b[:, 2], b[:, 1] + 0.5 * b[:, 3]
    pw, ph = _trunc(b[:, 2] * ratio), _trunc(b[:, 3] * ratio)
    return np.stack([_trunc(cx - pw / 2), _trunc(cy - ph / 2), pw, ph], -1)


def square_bbox(bbox: np.ndarray) -> np.ndarray:
    """[n, 4] -> [n, 5] (x1, y1, x2, y2, side) crop squares."""
    b = bbox.astype(np.float64)
    x1, y1 = b[:, 0], b[:, 1]
    bw, bh = np.maximum(b[:, 2], 0), np.maximum(b[:, 3], 0)
    x2, y2 = x1 + bw, y1 + bh
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    tall = bh > bw
    nx1 = np.where(tall, cx - bh / 2, x1)
    nx2 = np.where(tall, cx + bh / 2, x2)
    ny1 = np.where(tall, y1, cy - bw / 2)
    ny2 = np.where(tall, y2, cy + bw / 2)
    side = np.maximum(bh, bw).astype(np.int64)
    return np.stack([_trunc(nx1), _trunc(ny1), _trunc(nx2), _trunc(ny2),
                     side], -1)


def detections(bbox: np.ndarray, rng: np.random.Generator,
               scaled_share: float) -> np.ndarray:
    """A detector's boxes for GT boxes [n, 4], as `chip_smoke.py::
    vivo_detections` makes them (:820-848): every box within 3 px of
    its GT box; a `scaled_share` of them scaled 1.2x about the center."""
    near = bbox + rng.integers(-3, 4, bbox.shape)
    scaled = rng.random(len(bbox)) < scaled_share
    cx = near[:, 0] + near[:, 2] / 2
    cy = near[:, 1] + near[:, 3] / 2
    ww, hh = 1.2 * near[:, 2], 1.2 * near[:, 3]
    big = np.stack([np.round(cx - ww / 2), np.round(cy - hh / 2),
                    np.round(ww), np.round(hh)], -1).astype(np.int64)
    return np.where(scaled[:, None], big, near)


def crop_params(det: np.ndarray, padding_ratio: float):
    """Detections [n, 4] -> (roi_param [n, 5] int32, final_bbox [n, 4]
    int32) of the square crop, as the port's `CropDatasetHost` derives
    them for `crop_square_resize`."""
    sq = square_bbox(padding_bbox(det, padding_ratio))
    param = sq.copy()
    param[:, 4] = np.maximum(param[:, 4], 1)
    final = np.stack([sq[:, 0], sq[:, 1], sq[:, 2] - sq[:, 0],
                      sq[:, 3] - sq[:, 1]], -1)
    return param.astype(np.int32), final.astype(np.int32)
