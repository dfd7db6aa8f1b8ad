"""BOP-challenge pose errors (MSSD / MSPD / VSD) + BOP19 average recall.

Port of `zebrapose_tpu/ops/bop_errors.py`. The symmetry-aware errors
score ALL poses of an object against ALL symmetry transforms on the
tensors' device: a running `torch.minimum` over the symmetries (JAX's
`lax.scan`) of a [N,P,3] vertex-distance program, so memory stays flat
while continuous symmetries discretize to hundreds of transforms. VSD's
per-pixel visibility and cost math runs as one program over a stack of
depth images; only the depth rendering is host code (the port's copy of
the C++ rasterizer, `zebrapose_tpu_torch/native`).

None of this is a Pallas kernel in JAX (jitted `jnp` programs), so the
port is plain PyTorch in float32. The [N,P,3] transforms are written as
elementwise multiply-adds, not matmuls: JAX computes them at
`precision=HIGHEST`, and the result must not depend on
`torch.backends.cuda.matmul.allow_tf32`. `torch.minimum` propagates NaN
as `jnp.minimum` does (`torch.fmin` would not). Error definitions follow
BOP19 (Hodan et al., ECCV 2020).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from zebrapose_tpu_torch.utils.device import resolve_device


# ------------------------------------------------------------ symmetries


def _axis_angle_rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rotation about a (unit) axis through the origin (the 3x3 block of
    transform.rotation_matrix used by misc.get_symmetry_transformations)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)


def get_symmetry_transformations(model_info: Dict,
                                 max_sym_disc_step: float = 0.01
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """models_info.json entry -> stacked symmetry transforms
    ([S,3,3] rotations, [S,3] translations), identity included.

    Mirrors misc.get_symmetry_transformations (lib/pysixd/misc.py:206-260):
    discrete symmetries enumerate; continuous axis symmetries discretize
    into ceil(pi / max_sym_disc_step) steps; the two sets compose as
    cont ∘ disc."""
    Rs_d = [np.eye(3)]
    ts_d = [np.zeros(3)]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.reshape(np.asarray(sym, np.float64), (4, 4))
        Rs_d.append(m[:3, :3])
        ts_d.append(m[:3, 3])

    Rs_c, ts_c = [], []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], np.float64)
        offset = np.asarray(sym["offset"], np.float64)
        n = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n
        for i in range(1, n):
            R = _axis_angle_rotation(axis, i * step)
            Rs_c.append(R)
            ts_c.append(offset - R @ offset)

    Rs, ts = [], []
    for Rd, td in zip(Rs_d, ts_d):
        if Rs_c:
            for Rc, tc in zip(Rs_c, ts_c):
                Rs.append(Rc @ Rd)
                ts.append(Rc @ td + tc)
        else:
            Rs.append(Rd)
            ts.append(td)
    return (np.stack(Rs).astype(np.float32),
            np.stack(ts).astype(np.float32))


# ------------------------------------------------------- MSSD / MSPD


def _transform(R: torch.Tensor, t: torch.Tensor,
               pts: torch.Tensor) -> torch.Tensor:
    """R [N,3,3] · pts [P,3] + t [N,3] -> [N,P,3], in float32
    multiply-adds (no matmul, so no TF32)."""
    return (R[:, None, :, 0] * pts[None, :, 0, None]
            + R[:, None, :, 1] * pts[None, :, 1, None]
            + R[:, None, :, 2] * pts[None, :, 2, None]
            + t[:, None, :])


def _gt_sym_pose(R_gt, t_gt, sym_R, sym_t):
    """Compose one symmetry into the GT poses: [N,3,3],[N,3]."""
    R = (R_gt[:, :, :, None] * sym_R[None, None]).sum(2)
    t = (R_gt * sym_t[None, None, :]).sum(-1) + t_gt
    return R, t


def _norm(d: torch.Tensor) -> torch.Tensor:
    return (d * d).sum(-1).sqrt()


def mssd_batch(R_est: torch.Tensor, t_est: torch.Tensor,
               R_gt: torch.Tensor, t_gt: torch.Tensor,
               pts: torch.Tensor, sym_R: torch.Tensor,
               sym_t: torch.Tensor) -> torch.Tensor:
    """Maximum Symmetry-aware Surface Distance for N poses at once.

    min over symmetries of max over model points of
    ||R_est x + t_est - (R_gt S x + t_gt')|| — pose_error.py:131-154,
    batched: [N,3,3],[N,3] poses, [P,3] points, [S,3,3],[S,3] syms -> [N]
    float32 tensors on one device."""
    pts_est = _transform(R_est, t_est, pts)
    best = torch.full(R_est.shape[:1], torch.inf, dtype=pts_est.dtype,
                      device=pts_est.device)
    for R_s, t_s in zip(sym_R, sym_t):
        R, t = _gt_sym_pose(R_gt, t_gt, R_s, t_s)
        d = _norm(pts_est - _transform(R, t, pts)).amax(dim=1)
        best = torch.minimum(best, d)
    return best


def mspd_batch(R_est: torch.Tensor, t_est: torch.Tensor,
               R_gt: torch.Tensor, t_gt: torch.Tensor,
               K: torch.Tensor, pts: torch.Tensor,
               sym_R: torch.Tensor, sym_t: torch.Tensor) -> torch.Tensor:
    """Maximum Symmetry-aware Projection Distance, batched.

    pose_error.py:156-180 with misc.project_pts' K[R|t] projection;
    per-sample intrinsics K [N,3,3] -> [N] pixel errors. The projected z
    is divided by unguarded, as in JAX."""

    def project(R, t):
        cam = _transform(R, t, pts)
        uvw = (K[:, None, :, 0] * cam[..., 0:1]
               + K[:, None, :, 1] * cam[..., 1:2]
               + K[:, None, :, 2] * cam[..., 2:3])
        return uvw[..., :2] / uvw[..., 2:3]

    uv_est = project(R_est, t_est)
    best = torch.full(R_est.shape[:1], torch.inf, dtype=uv_est.dtype,
                      device=uv_est.device)
    for R_s, t_s in zip(sym_R, sym_t):
        R, t = _gt_sym_pose(R_gt, t_gt, R_s, t_s)
        d = _norm(uv_est - project(R, t)).amax(dim=1)
        best = torch.minimum(best, d)
    return best


# ------------------------------------------------------------------ VSD


def _vsd_parts(depth_test: torch.Tensor, depth_gt: torch.Tensor,
               depth_est: torch.Tensor, K: torch.Tensor,
               taus: torch.Tensor, delta: float, norm: torch.Tensor,
               cost_type: str = "step"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The terms of `_vsd_costs`: per image and tau the pixel costs
    summed over the intersection [N,T] (float32), and the counts of
    pixels in the union less the intersection [N] and in the union
    [N]."""
    h, w = depth_test.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(h, device=depth_test.device),
        torch.arange(w, device=depth_test.device), indexing="ij")
    rays = torch.stack([(xs + 0.0 - K[:, None, None, 0, 2])
                        / K[:, None, None, 0, 0],
                        (ys + 0.0 - K[:, None, None, 1, 2])
                        / K[:, None, None, 1, 1]], dim=-1)
    ray_norm = torch.sqrt(1.0 + (rays ** 2).sum(-1))

    d_test = depth_test * ray_norm
    d_gt = depth_gt * ray_norm
    d_est = depth_est * ray_norm

    def visib(d_model):
        return ((d_model - d_test <= delta) | (d_test == 0)) & (d_model > 0)

    visib_gt = visib(d_gt)
    visib_est = visib(d_est) | (visib_gt & (d_est > 0))
    inter = visib_gt & visib_est
    union = visib_gt | visib_est

    union_count = union.sum(dim=(1, 2))
    comp_count = union_count - inter.sum(dim=(1, 2))
    dists = (d_gt - d_est).abs() / norm[:, None, None]

    if cost_type == "step":
        costs = (dists[:, None] >= taus[None, :, None, None]).float()
    elif cost_type == "tlinear":
        costs = torch.clamp(dists[:, None] / taus[None, :, None, None],
                            max=1.0)
    else:
        raise ValueError(f"unknown cost_type: {cost_type}")
    costs = torch.where(inter[:, None], costs, 0.0).sum(dim=(2, 3))
    return costs, comp_count, union_count


def _vsd_costs(depth_test: torch.Tensor, depth_gt: torch.Tensor,
               depth_est: torch.Tensor, K: torch.Tensor,
               taus: torch.Tensor, delta: float, norm: torch.Tensor,
               cost_type: str = "step") -> torch.Tensor:
    """All-pixel VSD math for a stack of images: [N,H,W] depths ->
    [N,T] errors (one per misalignment tolerance tau).

    Implements depth->distance conversion (misc.py:571-590; rays through
    the integer pixel grid), the bop19 visibility masks
    (visibility.py:9-77: visible where the model is in front of the
    measured surface OR depth is missing; the estimate additionally
    inherits GT-visible model pixels) and the step/tlinear pixel costs
    (pose_error.py:108-128). An empty union gives error 1."""
    costs, comp_count, union_count = _vsd_parts(
        depth_test, depth_gt, depth_est, K, taus, delta, norm, cost_type)
    return _vsd_errors(costs, comp_count, union_count)


def _vsd_errors(costs: torch.Tensor, comp_count: torch.Tensor,
                union_count: torch.Tensor) -> torch.Tensor:
    e = (costs + comp_count[:, None]) / union_count[:, None]
    return torch.where(union_count[:, None] == 0, 1.0, e)


def vsd_batch(R_est: np.ndarray, t_est: np.ndarray,
              R_gt: np.ndarray, t_gt: np.ndarray,
              depth_test: np.ndarray, K: np.ndarray,
              vertices: np.ndarray, faces: np.ndarray,
              diameter: float,
              taus: Sequence[float] = tuple(np.arange(0.05, 0.51, 0.05)),
              delta: float = 15.0,
              normalized_by_diameter: bool = True,
              cost_type: str = "step", device=None) -> np.ndarray:
    """Visible Surface Discrepancy for N poses: renders est/GT depth with
    the rasterizer (host), then one program on `device` (CUDA unless
    "cpu" is asked for) for the visibility/cost math over the whole
    stack. Returns [N, len(taus)].

    Matches pose_error.py:22-130 with the bop19 visibility mode."""
    from zebrapose_tpu_torch.native import render_label

    dev = resolve_device(device)
    n, h, w = depth_test.shape
    depth_est = np.zeros((n, h, w), np.float32)
    depth_gt = np.zeros((n, h, w), np.float32)
    labels = np.ones(len(faces), np.int32)
    for i in range(n):
        _, depth_est[i] = render_label(
            vertices, faces, labels, K[i], R_est[i], t_est[i], w, h,
            with_depth=True)
        _, depth_gt[i] = render_label(
            vertices, faces, labels, K[i], R_gt[i], t_gt[i], w, h,
            with_depth=True)

    norm = np.full((n,), diameter if normalized_by_diameter else 1.0,
                   np.float32)

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return _vsd_costs(
        on(depth_test), on(depth_gt), on(depth_est), on(K), on(taus),
        float(delta), on(norm), cost_type=cost_type).cpu().numpy()


# -------------------------------------------------------- BOP19 scoring


def bop19_average_recalls(errs_vsd: Optional[np.ndarray],
                          errs_mssd: np.ndarray,
                          errs_mspd: np.ndarray,
                          diameter: float,
                          im_width: int = 640) -> Dict[str, float]:
    """BOP19 average recalls from per-pose errors of ONE object.

    Thresholds of correctness (bop_toolkit eval conventions):
      MSSD: theta in {0.05..0.5} * diameter       (10 thresholds)
      MSPD: theta in {5..50} * im_width/640 px    (10 thresholds)
      VSD:  errs_vsd [N, 10] at taus {0.05..0.5}, each judged against
            theta in {0.05..0.5}                  (10x10 combinations)
    Missing poses should be encoded as +inf errors by the caller (they
    count as misses at every threshold). errs_vsd=None (no depth data)
    omits AR_vsd and averages the core over MSSD+MSPD only."""
    thetas = np.arange(0.05, 0.51, 0.05)
    ar_mssd = float(np.mean([
        np.mean(errs_mssd < th * diameter) for th in thetas]))
    r = im_width / 640.0
    ar_mspd = float(np.mean([
        np.mean(errs_mspd < th * r) for th in np.arange(5, 51, 5)]))
    out = {"AR_mssd": ar_mssd, "AR_mspd": ar_mspd}
    if errs_vsd is not None:
        ar_vsd = float(np.mean([
            np.mean(errs_vsd[:, i] < th)
            for i in range(errs_vsd.shape[1]) for th in thetas]))
        out["AR_vsd"] = ar_vsd
        out["AR"] = float((ar_vsd + ar_mssd + ar_mspd) / 3.0)
    else:
        out["AR"] = float((ar_mssd + ar_mspd) / 2.0)
    return out
