"""Batched EPnP + RANSAC pose solver on the device.

Port of `zebrapose_tpu/ops/pnp.py`. Where JAX writes one instance and
vmaps it, these functions carry the batch as explicit leading dims:

  * correspondences: predicted code planes -> class ids -> one gather
    from the packed [C, 4] LUT; every pixel takes part with weight =
    foreground (no ragged shapes). When P > cfg.max_points every stage
    works on a <= max_points subset: one random foreground
    representative per contiguous raster block plus an exact compaction
    of the first min(64, max_points/8) foreground pixels.
  * hypotheses: n_hypotheses minimal sets by inverse-CDF sampling,
    solved by `_solve_hypotheses`. Width-6 EPnP with fast_linalg (the
    default, sample_size <= 6) is the hypothesis kernel
    (`ops/pnp_kernel.py`: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors). The solver options run as torch ops on
    the run's device, the card included: `hyp_solver="dlt"` (`dlt_p6p`),
    `fast_linalg=False` (`torch.linalg.eigh` / `svd` / `det`) and
    `sample_size > 6`. That is the JAX package's own split, not a
    fallback: its `minimal_epnp_hypotheses` leaves the Pallas kernel for
    fast=False and widths other than 6, and DLT never reaches it, so
    those options run as jnp on the TPU there.
  * scoring, refit on the inliers, SE(3) polish and the success gate
    (`_ransac_finish`) are plain torch, as they are plain XLA in JAX.

Random draws: JAX's threefry stream cannot be reproduced in torch, so
`_ransac_prepare` / `_draw_minimal_samples` take optional uniforms in
[0, 1) (`RansacDraws`); without them they draw from the caller's
`torch.Generator`. Given the same uniforms both stacks pick the same
subsets and minimal sets. `draw_ransac_uniforms` draws from a generator
exactly what the two functions would draw from it (prio first, then u):
an exported serving program takes these uniforms as inputs, since
`torch.export` cannot take a generator. They are the port's form of the
`key[2] u32` input of the JAX package's serving signature
(`eval/export_serving.py`). With draws, the stage-1 decode has no host
sync and no branch on a tensor's value, so it traces; escalation (one
`.item()` a batch) stays out of exported programs, as JAX's export sets
only `n_hypotheses` and `max_points`.

Precision: the pose path is float32 end to end and uses matmuls only
(no convolutions); `torch.backends.cuda.matmul.allow_tf32` is left at
its default False, so no TF32 rounding reaches it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from zebrapose_tpu_torch.ops.fast_linalg import (
    _det3,
    _sign,
    polar_rotation,
    smallest_subspace,
    solve_psd_small,
)
from zebrapose_tpu_torch.utils.profiling import span

@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """Same fields and defaults as the JAX `PnPConfig` (see its comments
    for the reasoning behind each default)."""

    n_hypotheses: int = 128
    sample_size: int = 5
    reproj_threshold: float = 2.0
    refine_iters: int = 2
    max_points: int = 4096
    min_points: int = 6
    gn_iters: int = 5
    fast_linalg: bool = True
    polish_iters: int = 3
    hyp_solver: str = "epnp"
    escalate_hypotheses: int = 0
    escalate_inlier_frac: float = 0.4
    lo_top_k: int = 1


@dataclasses.dataclass
class RansacDraws:
    """Injected uniforms in [0, 1), one row per instance.

    prio: [B, P_pad] subset-representative priorities (only read when
          P > max_points; P_pad = P rounded up to whole blocks).
    u:    [B, n_hypotheses, sample_size] minimal-set draws.
    u2:   [B, escalate_hypotheses, sample_size] stage-2 draws (only read
          when escalation runs).
    """

    prio: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None
    u2: Optional[torch.Tensor] = None


def _check_cfg(cfg: PnPConfig) -> None:
    if cfg.hyp_solver not in ("epnp", "dlt"):
        raise ValueError(f"hyp_solver={cfg.hyp_solver!r}: 'epnp' or 'dlt'")


def _uniform(shape, given: Optional[torch.Tensor],
             generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"injected uniforms have shape "
                             f"{tuple(given.shape)}, expected {shape}")
        return given.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("pass a torch.Generator or injected RansacDraws")
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def project_points(pts3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] world -> [..., N, 2] pixels under x_c = R X + t
    (batch dims of pts3d, R, t, K broadcast)."""
    pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    pz = pc[..., 2]
    z = torch.clamp_min(pz.abs(), 1e-8) * _sign(
        torch.where(pz == 0, 1.0, pz))
    u = K[..., 0, 0, None] * pc[..., 0] / z + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * pc[..., 1] / z + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# Weighted EPnP core (fast=True), batched over leading dims
# ---------------------------------------------------------------------------

_PAIRS_P = (0, 0, 0, 1, 1, 2)
_PAIRS_Q = (1, 2, 3, 2, 3, 3)


def _control_points(pts: torch.Tensor, w: torch.Tensor, fast: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World control points [..., 4, 3] + barycentric coords [..., N, 4]:
    the weighted centroid plus three scaled axes, per-axis rms spreads
    along x, y, z (fast=True) or the weighted-PCA axes (fast=False).
    Scales are floored so planar point sets stay non-degenerate."""
    wsum = torch.clamp_min(w.sum(-1), 1e-8)[..., None]
    c0 = (pts * w[..., None]).sum(-2) / wsum
    d = pts - c0[..., None, :]
    if fast:
        var = (d * d * w[..., None]).sum(-2) / wsum            # [..., 3]
        scale = torch.sqrt(torch.maximum(
            var, 1e-6 * var.amax(-1, keepdim=True) + 1e-9))
        ctrl = torch.cat([c0[..., None, :],
                          c0[..., None, :] + torch.diag_embed(scale)], -2)
        a123 = d / scale[..., None, :]
    else:
        cov = (d * w[..., None]).transpose(-1, -2) @ d / wsum[..., None]
        evals, evecs = _eigh(cov)                              # ascending
        scale = torch.sqrt(torch.maximum(
            evals, 1e-6 * evals.amax(-1, keepdim=True) + 1e-9))
        axes = evecs * scale[..., None, :]       # columns = scaled axes
        ctrl = torch.cat([c0[..., None, :],
                          c0[..., None, :] + axes.transpose(-1, -2)], -2)
        inv_axes = evecs / torch.clamp_min(scale[..., None, :], 1e-12)
        a123 = d @ inv_axes                                    # [..., N, 3]
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return ctrl, torch.cat([a0, a123], dim=-1)


def _eigh(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.eigh of symmetric [..., n, n] (ascending); a matrix
    with a non-finite entry gives NaN, as jnp.linalg.eigh does, where
    LAPACK / cuSOLVER would stop the whole batch with an error."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], eye,
                                                 A))
    return (torch.where(bad[..., None], torch.nan, evals),
            torch.where(bad[..., None, None], torch.nan, evecs))


def _svd_rotation(H: torch.Tensor) -> torch.Tensor:
    """The proper rotation U diag(1, 1, sign det(U Vᵀ)) Vᵀ nearest
    [..., 3, 3] by SVD (NaN for a non-finite matrix, as in JAX)."""
    bad = ~torch.isfinite(H).all(-1).all(-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    U, _, Vh = torch.linalg.svd(torch.where(bad[..., None, None], eye, H))
    d = _sign(torch.linalg.det(U @ Vh))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], -1))
    return torch.where(bad[..., None, None], torch.nan, U @ D @ Vh)


def _build_mtm(alphas: torch.Tensor, pts2d: torch.Tensor, w: torch.Tensor,
               K: torch.Tensor) -> torch.Tensor:
    """Weighted MᵀM [..., 12, 12] = Σ_i w_i kron(α_i α_iᵀ, B_iᵀ B_i)."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    du = cx - pts2d[..., 0]
    dv = cy - pts2d[..., 1]
    zeros = torch.zeros_like(du)
    btb = torch.stack([
        (fx * fx).expand_as(du), zeros, fx * du,
        zeros, (fy * fy).expand_as(du), fy * dv,
        fx * du, fy * dv, du * du + dv * dv,
    ], dim=-1)                                                 # [..., N, 9]
    aat = (alphas[..., :, None] * alphas[..., None, :]).flatten(-2)
    blocks = (aat * w[..., None]).transpose(-1, -2) @ btb      # [..., 16, 9]
    shape = blocks.shape[:-2]
    return blocks.reshape(shape + (4, 4, 3, 3)).transpose(-3, -2).reshape(
        shape + (12, 12))


def _l6x10_and_rho(V: torch.Tensor, ctrl_w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L [..., 6, 10] over control-point pairs and the world squared
    distances rho [..., 6]; L's columns follow the beta products
    [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]."""
    cc = V.reshape(V.shape[:-2] + (4, 3, 4))                   # ctrl,xyz,b
    p, q = list(_PAIRS_P), list(_PAIRS_Q)
    dv = cc[..., p, :, :] - cc[..., q, :, :]                   # [..., 6,3,4]
    dots = torch.einsum("...pxa,...pxb->...pab", dv, dv)
    L = torch.stack([
        dots[..., 0, 0], 2 * dots[..., 0, 1], dots[..., 1, 1],
        2 * dots[..., 0, 2], 2 * dots[..., 1, 2], dots[..., 2, 2],
        2 * dots[..., 0, 3], 2 * dots[..., 1, 3], 2 * dots[..., 2, 3],
        dots[..., 3, 3],
    ], dim=-1)
    dw = ctrl_w[..., p, :] - ctrl_w[..., q, :]
    return L, (dw * dw).sum(-1)


def _solve_ls(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares [..., m, k] x = [..., m] via 1e-9·trace-regularized
    normal equations and the unrolled Cholesky."""
    At = A.transpose(-1, -2)
    ata = At @ A
    k = A.shape[-1]
    tr = ata.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    ata = ata + 1e-9 * tr * torch.eye(k, dtype=A.dtype, device=A.device)
    atb = At @ b[..., None]
    return solve_psd_small(ata, atb)[..., 0]


def _betas_case1(L, rho):
    x = _solve_ls(L[..., [0, 1, 3, 6]], rho)
    x0 = x[..., 0]
    b1 = torch.sqrt(x0.abs())
    s = _sign(x0) + (x0 == 0)
    rest = s[..., None] * x[..., 1:] / torch.clamp_min(b1, 1e-12)[..., None]
    return torch.cat([b1[..., None], rest], dim=-1)


def _betas_case2(L, rho):
    x = _solve_ls(L[..., [0, 1, 2]], rho)
    b1 = torch.sqrt(x[..., 0].abs())
    b2 = torch.sqrt(x[..., 2].abs()) * _sign(x[..., 1]) * _sign(x[..., 0])
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=-1)


def _betas_case3(L, rho):
    x = _solve_ls(L[..., [0, 1, 2, 3, 4]], rho)
    b1 = torch.sqrt(x[..., 0].abs())
    b2 = torch.sqrt(x[..., 2].abs()) * _sign(x[..., 1]) * _sign(x[..., 0])
    b3 = x[..., 3] / torch.clamp_min(b1, 1e-12) * _sign(x[..., 0])
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


def _beta_products(b: torch.Tensor) -> torch.Tensor:
    b1, b2, b3, b4 = b.unbind(-1)
    return torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
                        b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], -1)


def _gauss_newton_betas(L: torch.Tensor, rho: torch.Tensor,
                        betas: torch.Tensor, iters: int) -> torch.Tensor:
    """Refine betas minimizing ||L · prods(betas) - rho||."""
    for _ in range(iters):
        b1, b2, b3, b4 = betas.unbind(-1)
        z = torch.zeros_like(b1)
        dp = torch.stack([
            torch.stack([2 * b1, z, z, z], -1),
            torch.stack([b2, b1, z, z], -1),
            torch.stack([z, 2 * b2, z, z], -1),
            torch.stack([b3, z, b1, z], -1),
            torch.stack([z, b3, b2, z], -1),
            torch.stack([z, z, 2 * b3, z], -1),
            torch.stack([b4, z, z, b1], -1),
            torch.stack([z, b4, z, b2], -1),
            torch.stack([z, z, b4, b3], -1),
            torch.stack([z, z, z, 2 * b4], -1),
        ], dim=-2)                                             # [..., 10, 4]
        J = L @ dp                                             # [..., 6, 4]
        r = rho - (L @ _beta_products(betas)[..., None])[..., 0]
        betas = betas + _solve_ls(J, r)
    return betas


def _procrustes(pw: torch.Tensor, pc: torch.Tensor, w: torch.Tensor,
                fast: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid fit pc ~= R pw + t, R by the Newton polar factor
    (fast=True) or the SVD (fast=False)."""
    wsum = torch.clamp_min(w.sum(-1), 1e-8)[..., None]
    cw = (pw * w[..., None]).sum(-2) / wsum
    cc = (pc * w[..., None]).sum(-2) / wsum
    H = ((pc - cc[..., None, :]) * w[..., None]).transpose(-1, -2) @ (
        pw - cw[..., None, :])
    R = polar_rotation(H) if fast else _svd_rotation(H)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _pose_from_betas(betas, V, alphas, pts3d, w, fast: bool = True):
    x = (V @ betas[..., None])[..., 0]                         # [..., 12]
    cc = x.reshape(x.shape[:-1] + (4, 3))
    pc = alphas @ cc                                           # camera frame
    wsum = torch.clamp_min(w.sum(-1), 1e-8)
    zmean = (pc[..., 2] * w).sum(-1) / wsum
    flip = torch.where(zmean < 0, -1.0, 1.0)
    return _procrustes(pts3d, pc * flip[..., None, None], w, fast)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map [..., 3] -> [..., 3, 3]."""
    th = torch.sqrt((w * w).sum(-1))
    k = w / torch.clamp_min(th, 1e-12)[..., None]
    z = torch.zeros_like(th)
    Km = torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    s = torch.sin(th)[..., None, None]
    c = torch.cos(th)[..., None, None]
    R = eye + s * Km + (1.0 - c) * (Km @ Km)
    return torch.where((th < 1e-9)[..., None, None], eye, R)


def gauss_newton_pose_polish(pts3d: torch.Tensor, pts2d: torch.Tensor,
                             w: torch.Tensor, K: torch.Tensor,
                             R: torch.Tensor, t: torch.Tensor,
                             iters: int = 3
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted reprojection Gauss-Newton on SE(3) (right-multiplied
    model-frame twist) over [..., N] correspondences."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    px, py, pz = pts3d.unbind(-1)
    zeros = torch.zeros_like(px)
    Px = torch.stack([
        torch.stack([zeros, -pz, py], -1),
        torch.stack([pz, zeros, -px], -1),
        torch.stack([-py, px, zeros], -1)], -2)               # [..., N, 3, 3]
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
        iz = 1.0 / torch.clamp_min(pc[..., 2], 1e-6)
        u = fx[..., None] * pc[..., 0] * iz + K[..., 0, 2, None]
        v = fy[..., None] * pc[..., 1] * iz + K[..., 1, 2, None]
        r = torch.stack([pts2d[..., 0] - u, pts2d[..., 1] - v], -1)
        Rn = R[..., None, :, :]
        dPc = torch.cat([-(Rn @ Px), Rn.expand(Px.shape)], -1)  # [..., N,3,6]
        izc = iz[..., None]
        Ju = fx[..., None, None] * (dPc[..., 0, :] * izc
                                    - pc[..., 0:1] * izc ** 2 * dPc[..., 2, :])
        Jv = fy[..., None, None] * (dPc[..., 1, :] * izc
                                    - pc[..., 1:2] * izc ** 2 * dPc[..., 2, :])
        J = torch.stack([Ju, Jv], dim=-2)                      # [..., N, 2, 6]
        Jw = J * w[..., None, None]
        Hm = torch.einsum("...nri,...nrj->...ij", Jw, J)
        tr = Hm.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
        Hm = Hm + 1e-6 * tr / 6.0 * eye6
        b = torch.einsum("...nri,...nr->...i", Jw, r)
        xi = solve_psd_small(Hm, b[..., None])[..., 0]
        R_new = R @ _so3_exp(xi[..., :3])
        t_new = t + (R @ xi[..., 3:, None])[..., 0]
        # guard against a diverging step (all-outlier degenerate sets)
        ok = torch.isfinite(xi).all(-1) & (
            torch.sqrt((xi[..., 3:] ** 2).sum(-1)) < 1e3)
        R = torch.where(ok[..., None, None], R_new, R)
        t = torch.where(ok[..., None], t_new, t)
    return R, t


def dlt_p6p(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
            fast: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct P6P: [..., S >= 6, 3], [..., S, 2], K [..., 3, 3] ->
    (R [..., 3, 3], t [..., 3]).

    The DLT rows are EPnP's M rows with the homogeneous frame as control
    points (alphas = [X, 1]); the null vector stacks the columns of s·R
    and s·t. s comes from the determinant, orthogonality from one polar
    projection. Poor on near-planar minimal sets and ~30x worse than
    EPnP on 0.5 px noise (JAX's measurement), so it is an option
    (`PnPConfig.hyp_solver`). fast=True: the k=1 inverse subspace
    iteration and the Newton polar factor; fast=False: eigh and SVD.
    """
    alphas = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)
    mtm = _build_mtm(alphas, pts2d, torch.ones_like(pts3d[..., 0]), K)
    if fast:
        v = smallest_subspace(mtm, k=1)[..., 0]                # [..., 12]
    else:
        v = _eigh(mtm)[1][..., 0]
    cols = v.reshape(v.shape[:-1] + (4, 3))  # rows: s·R's columns, s·t
    R_tilde = cols[..., :3, :].transpose(-1, -2)
    det = _det3(R_tilde)
    s = _sign(det) * torch.pow(torch.clamp_min(det.abs(), 1e-20), 1.0 / 3)
    R_n = R_tilde / s[..., None, None]
    R = polar_rotation(R_n) if fast else _svd_rotation(R_n)
    return R, cols[..., 3, :] / s[..., None]


def epnp(pts3d: torch.Tensor, pts2d: torch.Tensor, w: torch.Tensor,
         K: torch.Tensor, gn_iters: int = 5, fast: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted EPnP: [..., N, 3], [..., N, 2], weights [..., N],
    K [..., 3, 3] -> (R [..., 3, 3], t [..., 3]).

    The three closed-form beta initializations run side by side as one
    extra batch dim (JAX vmaps them), each Gauss-Newton refined; the one
    with the lowest weighted reprojection error wins (first on ties).
    fast=True: axis-aligned control points, the k=4 inverse subspace
    iteration and the Newton polar factor; fast=False: weighted-PCA
    control points, eigh for the null-space basis and SVD Procrustes.
    """
    ctrl_w, alphas = _control_points(pts3d, w, fast)
    mtm = _build_mtm(alphas, pts2d, w, K)
    V = smallest_subspace(mtm, k=4) if fast else _eigh(mtm)[1][..., :4]
    L, rho = _l6x10_and_rho(V, ctrl_w)
    betas0 = torch.stack([_betas_case1(L, rho), _betas_case2(L, rho),
                          _betas_case3(L, rho)], dim=-2)      # [..., 3, 4]
    betas = _gauss_newton_betas(L[..., None, :, :], rho[..., None, :],
                                betas0, gn_iters)
    Rs, ts = _pose_from_betas(betas, V[..., None, :, :],
                              alphas[..., None, :, :],
                              pts3d[..., None, :, :], w[..., None, :], fast)
    proj = project_points(pts3d[..., None, :, :], Rs, ts,
                          K[..., None, :, :])
    se = ((proj - pts2d[..., None, :, :]) ** 2).sum(-1)
    errs = (se * w[..., None, :]).sum(-1) / torch.clamp_min(
        w.sum(-1), 1e-8)[..., None]
    errs = torch.where(torch.isnan(errs), torch.inf, errs)
    best = torch.argmin(errs, dim=-1)                          # first min
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))
    t = torch.gather(ts, -2, best[..., None, None].expand(best.shape + (1, 3)))
    return R[..., 0, :, :], t[..., 0, :]


# ---------------------------------------------------------------------------
# RANSAC, batched over instances [B, ...]
# ---------------------------------------------------------------------------

def subset_pad_len(P: int, cfg: PnPConfig) -> int:
    """Number of subset-priority draws (`RansacDraws.prio` columns) for
    P correspondences: P rounded up to whole blocks, 0 if no subset."""
    if P <= cfg.max_points:
        return 0
    q_blocks = cfg.max_points - min(64, cfg.max_points // 8)
    return q_blocks * -(-P // q_blocks)


def draw_ransac_uniforms(generator: torch.Generator, batch: int, P: int,
                         cfg: PnPConfig) -> RansacDraws:
    """The stage-1 uniforms `_ransac_prepare` and `_draw_minimal_samples`
    draw from `generator` for a batch of `batch` instances with P
    correspondences each, in their order, shapes and dtype: prio [batch,
    subset_pad_len(P, cfg)] (drawn only when a subset is built; else a
    [batch, 0] tensor), then u [batch, n_hypotheses, sample_size]. Passed
    as `draws`, they give the poses that `generator` itself gives."""
    dev = generator.device
    n_pad = subset_pad_len(P, cfg)
    prio = torch.rand((batch, n_pad), generator=generator, device=dev,
                      dtype=torch.float32) if n_pad else torch.zeros(
                          (batch, 0), device=dev)
    u = torch.rand((batch, cfg.n_hypotheses, cfg.sample_size),
                   generator=generator, device=dev, dtype=torch.float32)
    return RansacDraws(prio=prio, u=u)


def _ransac_prepare(pts3d: torch.Tensor, pts2d: torch.Tensor,
                    w: torch.Tensor, cfg: PnPConfig,
                    prio_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Subset build + minimal-set sampling for [B, P] correspondences.

    Returns (sub3d [B,Q,3], sub2d [B,Q,2], sub_w [B,Q], samp3d [B,H,S,3],
    samp2d [B,H,S,2], n_fg [B]) with S = max(sample_size, 6); n_fg is
    the TRUE count of w > 0 correspondences, for the success gate.
    """
    B, P = w.shape
    dev = w.device
    n_fg = (w > 0).sum(-1)
    n_pad = subset_pad_len(P, cfg)
    if n_pad:
        n_exact = min(64, cfg.max_points // 8)
        q_blocks = cfg.max_points - n_exact
        blk = n_pad // q_blocks
        pad = n_pad - P
        # zero-weight padding is never chosen over real foreground
        pts3d_b = torch.nn.functional.pad(pts3d, (0, 0, 0, pad))
        pts2d_b = torch.nn.functional.pad(pts2d, (0, 0, 0, pad))
        w_b = torch.nn.functional.pad(w, (0, pad))
        r = _uniform((B, n_pad), prio_u, generator, dev)
        prio = w_b + w_b * (r * 0.5)
        rep = torch.argmax(prio.reshape(B, q_blocks, blk), dim=-1)
        idx = rep + torch.arange(q_blocks, device=dev) * blk   # [B, Qb]
        sub3d = torch.gather(pts3d_b, 1, idx[..., None].expand(-1, -1, 3))
        sub2d = torch.gather(pts2d_b, 1, idx[..., None].expand(-1, -1, 2))
        sub_w = torch.gather(w_b, 1, idx)
        if n_exact:
            # the s-th foreground pixel is the first index whose running
            # foreground count reaches s + 1
            cdf = torch.cumsum((w > 0).float(), dim=-1)
            qv = (torch.arange(n_exact, device=dev, dtype=torch.float32)
                  + 0.5).expand(B, -1).contiguous()
            eidx = torch.searchsorted(cdf, qv, right=False).clamp(0, P - 1)
            emask = (torch.arange(n_exact, device=dev)[None, :]
                     < n_fg[:, None]).to(w.dtype)
            sub3d = torch.cat([sub3d, torch.gather(
                pts3d, 1, eidx[..., None].expand(-1, -1, 3))], dim=1)
            sub2d = torch.cat([sub2d, torch.gather(
                pts2d, 1, eidx[..., None].expand(-1, -1, 2))], dim=1)
            sub_w = torch.cat([sub_w, torch.gather(w, 1, eidx) * emask],
                              dim=1)
    else:
        sub3d, sub2d, sub_w = pts3d, pts2d, w
    samp3d, samp2d = _draw_minimal_samples(sub3d, sub2d, sub_w, cfg,
                                           cfg.n_hypotheses, u, generator)
    return sub3d, sub2d, sub_w, samp3d, samp2d, n_fg


def _draw_minimal_samples(sub3d: torch.Tensor, sub2d: torch.Tensor,
                          sub_w: torch.Tensor, cfg: PnPConfig, n_hyp: int,
                          u: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """n_hyp minimal sets per instance, uniform over the w > 0 subset
    with replacement (inverse-CDF). sample_size < 6 is padded to the
    kernel's width 6 by repeating the last draw (a duplicated
    correspondence only double-weights one point of the least-squares
    solve); larger sizes keep their width.
    Returns (samp3d [B, n_hyp, S, 3], samp2d [B, n_hyp, S, 2]),
    S = max(sample_size, 6)."""
    B, Q = sub_w.shape
    S = cfg.sample_size
    cdf = torch.cumsum((sub_w > 0).float(), dim=-1)
    r = _uniform((B, n_hyp, S), u, generator, sub_w.device)
    uu = r * torch.clamp_min(cdf[:, -1], 1.0)[:, None, None]
    idx = torch.searchsorted(cdf, uu.reshape(B, -1), right=True)
    idx = idx.clamp(0, Q - 1).reshape(B, n_hyp, S)
    if S < 6:
        idx = torch.cat([idx, idx[..., -1:].expand(B, n_hyp, 6 - S)], -1)
    flat = idx.reshape(B, -1)
    s_eff = idx.shape[-1]
    samp3d = torch.gather(sub3d, 1, flat[..., None].expand(-1, -1, 3))
    samp2d = torch.gather(sub2d, 1, flat[..., None].expand(-1, -1, 2))
    return (samp3d.reshape(B, n_hyp, s_eff, 3),
            samp2d.reshape(B, n_hyp, s_eff, 2))


def _solve_hypotheses(samp3d: torch.Tensor, samp2d: torch.Tensor,
                      Ks: torch.Tensor, cfg: PnPConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimal-set solves of [B, H, S, .] samples with Ks [B, 3, 3] ->
    (Rs [B, H, 3, 3], ts [B, H, 3]).

    Width-6 EPnP with fast_linalg is one launch of the hypothesis kernel
    over the B·H solves (`ops/pnp_kernel.py`). DLT, fast_linalg=False and
    widths above 6 are torch ops on the samples' device, as JAX runs
    them as jnp outside its Pallas kernel (see the module docstring).
    """
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses

    B, H, S = samp3d.shape[:3]
    if cfg.hyp_solver == "epnp" and cfg.fast_linalg and S == 6:
        Rs, ts = minimal_epnp_hypotheses(
            samp3d.reshape(B * H, 6, 3).contiguous(),
            samp2d.reshape(B * H, 6, 2).contiguous(),
            Ks.repeat_interleave(H, dim=0).contiguous(), cfg.gn_iters)
        return Rs.reshape(B, H, 3, 3), ts.reshape(B, H, 3)
    Kh = Ks[:, None].expand(B, H, 3, 3)
    if cfg.hyp_solver == "dlt":
        return dlt_p6p(samp3d, samp2d, Kh, cfg.fast_linalg)
    return epnp(samp3d, samp2d, torch.ones_like(samp3d[..., 0]), Kh,
                cfg.gn_iters, cfg.fast_linalg)


def _ransac_finish(sub3d, sub2d, sub_w, Rs, ts, K, n_fg, cfg: PnPConfig):
    """Score [B, H] hypotheses, refit on inliers, polish, gate success.
    Returns (R [B,3,3], t [B,3], success [B] bool, n_inliers [B] int32).
    """
    B, Q = sub_w.shape
    fg = sub_w > 0

    def inliers_of(R, t, pts3d=sub3d, pts2d=sub2d, K_=K, fg_=fg):
        err = torch.sqrt(((project_points(pts3d, R, t, K_) - pts2d) ** 2)
                         .sum(-1))
        return (err < cfg.reproj_threshold) & fg_

    errs = torch.sqrt(((project_points(sub3d[:, None], Rs, ts, K[:, None])
                        - sub2d[:, None]) ** 2).sum(-1))       # [B, H, Q]
    errs = torch.where(torch.isnan(errs), torch.inf, errs)
    inliers = (errs < cfg.reproj_threshold) & fg[:, None, :]
    counts = inliers.sum(-1)

    def local_opt(R, t, inl, s3, s2, Kb, fgb):
        """Refit on inliers (refine_iters rounds) + SE(3) polish, for a
        batch of candidates with their own correspondences."""
        for _ in range(cfg.refine_iters):
            w_in = inl.to(s3.dtype)
            enough = w_in.sum(-1) >= cfg.min_points
            R2, t2 = epnp(s3, s2, w_in, Kb, cfg.gn_iters,
                          cfg.fast_linalg)
            inl2 = inliers_of(R2, t2, s3, s2, Kb, fgb)
            better = enough & (inl2.sum(-1) >= inl.sum(-1))
            R = torch.where(better[:, None, None], R2, R)
            t = torch.where(better[:, None], t2, t)
            inl = torch.where(better[:, None], inl2, inl)
        if cfg.polish_iters > 0:
            R_p, t_p = gauss_newton_pose_polish(
                s3, s2, inl.to(s3.dtype), Kb, R, t, cfg.polish_iters)
            in_p = inliers_of(R_p, t_p, s3, s2, Kb, fgb)
            # keep the polish only if it does not lose inliers
            better = in_p.sum(-1) >= inl.sum(-1)
            R = torch.where(better[:, None, None], R_p, R)
            t = torch.where(better[:, None], t_p, t)
            inl = torch.where(better[:, None], in_p, inl)
        return R, t, inl

    k = min(max(cfg.lo_top_k, 1), counts.shape[1])
    # stable descending sort: ties keep the lower hypothesis index first,
    # as argmax / lax.top_k do
    top = torch.sort(counts, dim=-1, descending=True, stable=True)[1][:, :k]
    Rk = torch.gather(Rs, 1, top[..., None, None].expand(-1, -1, 3, 3))
    tk = torch.gather(ts, 1, top[..., None].expand(-1, -1, 3))
    ik = torch.gather(inliers, 1, top[..., None].expand(-1, -1, Q))

    def rep(x):   # [B, ...] -> [B*k, ...]
        return x.repeat_interleave(k, dim=0)

    Rf, tf, inf_ = local_opt(Rk.reshape(B * k, 3, 3), tk.reshape(B * k, 3),
                             ik.reshape(B * k, Q), rep(sub3d), rep(sub2d),
                             rep(K), rep(fg))
    bk = torch.argmax(inf_.reshape(B, k, Q).sum(-1), dim=-1)   # [B]
    sel = torch.arange(B, device=bk.device) * k + bk
    R_fin, t_fin, in_fin = Rf[sel], tf[sel], inf_[sel]

    n_in = in_fin.sum(-1)
    success = (n_fg >= cfg.min_points) & (n_in >= cfg.min_points)
    eye = torch.eye(3, dtype=sub3d.dtype, device=sub3d.device)
    R_out = torch.where(success[:, None, None], R_fin, eye)
    t_out = torch.where(success[:, None], t_fin, torch.zeros_like(t_fin))
    return R_out, t_out, success, n_in.to(torch.int32)


def _escalation_needed(ok, n_in, n_fg, cfg: PnPConfig) -> torch.Tensor:
    """Weak-consensus gate for the second stage: the first round failed
    despite enough correspondences, or its inlier support is below
    escalate_inlier_frac of the foreground."""
    enough = n_fg >= cfg.min_points
    weak = n_in.float() < (cfg.escalate_inlier_frac * n_fg.float())
    return enough & (weak | ~ok)


# ---------------------------------------------------------------------------
# Full decode: mask + code planes -> pose
# ---------------------------------------------------------------------------

def _correspondences(mask, code, lut_points, lut_valid, bbox,
                     bbox_size: int, base: int):
    """[B,H,W] mask + [B,H,W,n] code planes -> (pts3d [B,H*W,3],
    pts2d [B,H*W,2], fg [B,H*W])."""
    from zebrapose_tpu_torch.codec.surface_code import code_to_class_id
    from zebrapose_tpu_torch.ops.roi import map_pixels_to_original

    B, h, w_img = mask.shape
    ids = code_to_class_id(code, base=base).reshape(B, -1).long()
    # one packed gather for xyz + validity ({0, 1} is exact in f32)
    packed = torch.cat([lut_points,
                        lut_valid.to(lut_points.dtype)[:, None]], dim=1)
    g = packed[ids]                                            # [B, HW, 4]
    fg = mask.reshape(B, -1) * g[..., 3].to(mask.dtype)
    pix = torch.arange(h * w_img, dtype=torch.int32, device=mask.device)
    px = torch.stack([pix % w_img, pix // w_img], dim=-1)      # (x, y)
    orig = map_pixels_to_original(px[None], bbox[:, None, :], bbox_size)
    return g[..., :3], orig.float(), fg


def _ransac(sub3d, sub2d, sub_w, samp3d, samp2d, n_fg, Ks,
            cfg: PnPConfig, u2: Optional[torch.Tensor],
            generator: Optional[torch.Generator]):
    """RANSAC over prepared [B, ...] subsets and samples: hypotheses,
    scoring / refit / polish, and the escalation stage. JAX gates stage
    2 with one lax.cond over the batch; here the same batch-level gate
    costs one host sync (needs.any().item())."""
    with span("zebrapose.decode.hypotheses"):
        Rs, ts = _solve_hypotheses(samp3d, samp2d, Ks, cfg)
    with span("zebrapose.decode.ransac_finish"):
        res = _ransac_finish(sub3d, sub2d, sub_w, Rs, ts, Ks, n_fg, cfg)
        if cfg.escalate_hypotheses <= 0:
            return res
        R1, t1, ok1, n_in1 = res
        needs = _escalation_needed(ok1, n_in1, n_fg, cfg)
        if not bool(needs.any().item()):
            return res
    with span("zebrapose.decode.escalation"):
        s3, s2 = _draw_minimal_samples(sub3d, sub2d, sub_w, cfg,
                                       cfg.escalate_hypotheses, u2,
                                       generator)
        Rs2, ts2 = _solve_hypotheses(s3, s2, Ks, cfg)
        R2, t2, ok2, n_in2 = _ransac_finish(sub3d, sub2d, sub_w, Rs2, ts2,
                                            Ks, n_fg, cfg)
        better = needs & (n_in2 > n_in1)
        return (torch.where(better[:, None, None], R2, R1),
                torch.where(better[:, None], t2, t1),
                torch.where(better, ok2, ok1),
                torch.where(better, n_in2, n_in1))


def _one(draws: Optional[RansacDraws]) -> RansacDraws:
    """One instance's draws (prio [P_pad], u [H, S], u2 [H2, S]) as a
    batch of one."""
    draws = draws or RansacDraws()
    return RansacDraws(*(None if x is None else torch.as_tensor(x)[None]
                         for x in (draws.prio, draws.u, draws.u2)))


def ransac_pnp(pts3d, pts2d, w, K, cfg: PnPConfig = PnPConfig(),
               generator: Optional[torch.Generator] = None,
               draws: Optional[RansacDraws] = None, device=None):
    """RANSAC + weighted EPnP over one instance's fixed-shape
    correspondences: pts3d [P, 3], pts2d [P, 2], w [P] in {0, 1}, K
    [3, 3] -> (R [3, 3], t [3], success, n_inliers), 0-d tensors for
    the last two. `draws` holds this instance's uniforms (prio [P_pad],
    u [n_hypotheses, S], u2 [escalate_hypotheses, S]), else they come
    from `generator`. The batch path (`decode_to_pose_batch`) on a
    batch of one: the same hypothesis solver, kernel included."""
    from zebrapose_tpu_torch.utils.device import resolve_device

    _check_cfg(cfg)
    dev = resolve_device(device, pts3d, pts2d, w)
    f32 = dict(device=dev, dtype=torch.float32)
    d = _one(draws)
    with span("zebrapose.decode.ransac_prepare"):
        prep = _ransac_prepare(torch.as_tensor(pts3d, **f32)[None],
                               torch.as_tensor(pts2d, **f32)[None],
                               torch.as_tensor(w, **f32)[None], cfg, d.prio,
                               d.u, generator)
    res = _ransac(*prep, torch.as_tensor(K, **f32)[None], cfg, d.u2,
                  generator)
    return tuple(x[0] for x in res)


def decode_to_pose(mask, code, lut_points, lut_valid, bbox, K,
                   bbox_size: int = 128, base: int = 2,
                   cfg: PnPConfig = PnPConfig(),
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[RansacDraws] = None, device=None):
    """One instance's CNN outputs -> pose: mask [H, W], code [H, W, n],
    bbox [4] (final bbox), K [3, 3] -> (R [3, 3], t [3], success,
    n_inliers). `decode_to_pose_batch` on a batch of one; `draws` holds
    this instance's uniforms as in `ransac_pnp`."""
    out = decode_to_pose_batch(
        torch.as_tensor(mask)[None], torch.as_tensor(code)[None],
        lut_points, lut_valid, torch.as_tensor(bbox)[None],
        torch.as_tensor(K)[None], bbox_size=bbox_size, base=base, cfg=cfg,
        generator=generator, draws=_one(draws), device=device)
    return tuple(x[0] for x in out)


def decode_to_pose_batch(masks, codes, lut_points, lut_valid, bboxes, Ks,
                         bbox_size: int = 128, base: int = 2,
                         cfg: PnPConfig = PnPConfig(),
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[RansacDraws] = None,
                         device=None):
    """masks [B,H,W], codes [B,H,W,n], lut_points [C,3], lut_valid [C],
    bboxes [B,4] (final bbox), Ks [B,3,3] -> (R [B,3,3], t [B,3],
    success [B], n_inliers [B]).

    The hypothesis stage (`_solve_hypotheses`) is, with the default
    solver, one launch of the CUDA kernel over the B·n_hypotheses
    minimal sets on CUDA tensors (its plain version on CPU tensors), and
    a second with escalation. Draws come from `draws` when given, else
    `generator` (a generator on the run's device).
    """
    from zebrapose_tpu_torch.utils.device import resolve_device

    _check_cfg(cfg)
    dev = resolve_device(device, masks, codes, lut_points)
    draws = draws or RansacDraws()
    f32 = dict(device=dev, dtype=torch.float32)
    masks = torch.as_tensor(masks, **f32)
    codes = torch.as_tensor(codes, device=dev)
    lut_points = torch.as_tensor(lut_points, **f32)
    lut_valid = torch.as_tensor(lut_valid, device=dev)
    bboxes = torch.as_tensor(bboxes, device=dev)
    Ks = torch.as_tensor(Ks, **f32)

    with span("zebrapose.decode.correspondences"):
        pts3d, orig, fg = _correspondences(masks, codes, lut_points,
                                           lut_valid, bboxes, bbox_size, base)
    with span("zebrapose.decode.ransac_prepare"):
        prep = _ransac_prepare(pts3d, orig, fg, cfg, draws.prio, draws.u,
                               generator)
    return _ransac(*prep, Ks, cfg, draws.u2, generator)
