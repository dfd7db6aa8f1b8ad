"""Pose-error metrics: ADD / ADD-S (ADI), recall and AUC aggregators.

Port of `zebrapose_tpu/ops/metrics.py`. Per-pose errors are torch
functions (batch dims of R/t broadcast); ADI's nearest-neighbour search
is a chunked pairwise-distance min with bounded memory. The aggregators
are small numpy reductions (host side). Model points in millimetres.
"""

from __future__ import annotations

import numpy as np
import torch


def transform_points(points: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """[N, 3] x [..., 3, 3] + [..., 3] -> [..., N, 3] (float32 matmul)."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def add_error(R_est, t_est, R_gt, t_gt, points) -> torch.Tensor:
    """Average Distance of Model Points (bop_toolkit pose_error.add)."""
    pe = transform_points(points, R_est, t_est)
    pg = transform_points(points, R_gt, t_gt)
    return torch.sqrt(((pe - pg) ** 2).sum(-1)).mean(-1)


def adi_error(R_est, t_est, R_gt, t_gt, points,
              chunk: int = 512) -> torch.Tensor:
    """ADD for indistinguishable views (bop_toolkit pose_error.adi): for
    each GT-transformed point, the distance to the nearest est-transformed
    point, averaged; ||a-b||² = |a|² + |b|² - 2ab over chunks of GT
    points."""
    pe = transform_points(points, R_est, t_est)
    pg = transform_points(points, R_gt, t_gt)
    pe2 = (pe ** 2).sum(-1)
    total = torch.zeros(pg.shape[:-2], dtype=pg.dtype, device=pg.device)
    for s in range(0, pg.shape[-2], chunk):
        pgc = pg[..., s:s + chunk, :]
        d2 = ((pgc ** 2).sum(-1)[..., :, None] + pe2[..., None, :]
              - 2.0 * pgc @ pe.transpose(-1, -2))
        total = total + torch.sqrt(torch.clamp_min(
            d2.amin(-1), 0.0)).sum(-1)
    return total / pg.shape[-2]


def pose_error(R_est, t_est, R_gt, t_gt, points, symmetric: bool
               ) -> torch.Tensor:
    """ADD for asymmetric objects, ADI for symmetric (BOP ADD(-S))."""
    if symmetric:
        return adi_error(R_est, t_est, R_gt, t_gt, points)
    return add_error(R_est, t_est, R_gt, t_gt, points)


def recall_at(errors: np.ndarray, diameter: float,
              fraction: float = 0.1) -> float:
    """Fraction of errors below `fraction * diameter`."""
    errors = np.asarray(errors)
    if errors.size == 0:
        return 0.0
    return float(np.mean(errors < diameter * fraction))


def auc_step(errors: np.ndarray, thresholds=None) -> np.ndarray:
    """Per-image 10-step AUC over thresholds 10..100 mm."""
    if thresholds is None:
        thresholds = np.linspace(10, 100, num=10)
    errors = np.asarray(errors)
    return (errors[:, None] < thresholds[None, :]).mean(axis=1)


def auc_posecnn(errors: np.ndarray) -> float:
    """PoseCNN-style AUC with a 0.1 m cutoff; `errors` in metres."""
    d = np.sort(np.asarray(errors, dtype=np.float64).copy())
    n = d.shape[0]
    if n == 0:
        return float("nan")
    d[d > 0.1] = np.inf
    accuracy = np.cumsum(np.ones(n)) / n
    ids = np.isfinite(d)
    if ids.sum() == 0:
        return float("nan")
    rec = d[ids]
    prec = accuracy[ids]
    mrec = np.concatenate(([0], rec, [0.1]))
    mpre = np.concatenate(([0], prec, [prec[-1]]))
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    ids2 = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(((mrec[ids2] - mrec[ids2 - 1]) * mpre[ids2]).sum() * 10)
