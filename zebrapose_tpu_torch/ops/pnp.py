"""Batched EPnP + RANSAC pose solver on the device.

Port of `zebrapose_tpu/ops/pnp.py`. Where JAX writes one instance and
vmaps it, these functions carry the batch as explicit leading dims:

  * correspondences: predicted code planes -> class ids -> one gather
    from the packed [C, 4] LUT; every pixel takes part with weight =
    foreground (no ragged shapes). When P > cfg.max_points every stage
    works on a <= max_points subset: one random foreground
    representative per contiguous raster block plus an exact compaction
    of the first min(64, max_points/8) foreground pixels.
  * hypotheses: n_hypotheses minimal 6-point sets by inverse-CDF
    sampling, solved by the hypothesis kernel (`ops/pnp_kernel.py`: the
    CUDA kernel for CUDA tensors, its plain version for CPU tensors).
  * scoring, refit on the inliers, SE(3) polish and the success gate
    (`_ransac_finish`) are plain torch, as they are plain XLA in JAX.

Random draws: JAX's threefry stream cannot be reproduced in torch, so
`_ransac_prepare` / `_draw_minimal_samples` take optional uniforms in
[0, 1) (`RansacDraws`); without them they draw from the caller's
`torch.Generator`. Given the same uniforms both stacks pick the same
subsets and minimal sets.

Precision: the pose path is float32 end to end and uses matmuls only
(no convolutions); `torch.backends.cuda.matmul.allow_tf32` is left at
its default False, so no TF32 rounding reaches it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from zebrapose_tpu_torch.ops.fast_linalg import (
    _sign,
    polar_rotation,
    smallest_subspace,
    solve_psd_small,
)

_UNPORTED = ("is not ported yet (see ROADMAP.md, queue A); the port runs "
             "hyp_solver='epnp', fast_linalg=True, sample_size <= 6")


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
    if cfg.hyp_solver != "epnp":
        raise NotImplementedError(f"hyp_solver={cfg.hyp_solver!r} "
                                  + _UNPORTED)
    if not cfg.fast_linalg:
        raise NotImplementedError("fast_linalg=False " + _UNPORTED)
    if cfg.sample_size > 6:
        raise NotImplementedError(f"sample_size={cfg.sample_size} "
                                  + _UNPORTED)


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


def _control_points(pts: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World control points [..., 4, 3] + barycentric coords [..., N, 4]:
    the weighted centroid plus per-axis rms-scaled axis points."""
    wsum = torch.clamp_min(w.sum(-1), 1e-8)[..., None]
    c0 = (pts * w[..., None]).sum(-2) / wsum
    d = pts - c0[..., None, :]
    var = (d * d * w[..., None]).sum(-2) / wsum                # [..., 3]
    scale = torch.sqrt(torch.maximum(
        var, 1e-6 * var.amax(-1, keepdim=True) + 1e-9))
    ctrl = torch.cat([c0[..., None, :],
                      c0[..., None, :] + torch.diag_embed(scale)], dim=-2)
    a123 = d / scale[..., None, :]
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return ctrl, torch.cat([a0, a123], dim=-1)


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


def _procrustes(pw: torch.Tensor, pc: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid fit pc ~= R pw + t, R by the Newton polar factor."""
    wsum = torch.clamp_min(w.sum(-1), 1e-8)[..., None]
    cw = (pw * w[..., None]).sum(-2) / wsum
    cc = (pc * w[..., None]).sum(-2) / wsum
    H = ((pc - cc[..., None, :]) * w[..., None]).transpose(-1, -2) @ (
        pw - cw[..., None, :])
    R = polar_rotation(H)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _pose_from_betas(betas, V, alphas, pts3d, w):
    x = (V @ betas[..., None])[..., 0]                         # [..., 12]
    cc = x.reshape(x.shape[:-1] + (4, 3))
    pc = alphas @ cc                                           # camera frame
    wsum = torch.clamp_min(w.sum(-1), 1e-8)
    zmean = (pc[..., 2] * w).sum(-1) / wsum
    flip = torch.where(zmean < 0, -1.0, 1.0)
    return _procrustes(pts3d, pc * flip[..., None, None], w)


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


def epnp(pts3d: torch.Tensor, pts2d: torch.Tensor, w: torch.Tensor,
         K: torch.Tensor, gn_iters: int = 5, fast: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted EPnP: [..., N, 3], [..., N, 2], weights [..., N],
    K [..., 3, 3] -> (R [..., 3, 3], t [..., 3]).

    The three closed-form beta initializations run side by side as one
    extra batch dim (JAX vmaps them), each Gauss-Newton refined; the one
    with the lowest weighted reprojection error wins (first on ties).
    """
    if not fast:
        raise NotImplementedError("fast=False (eigh/svd EPnP) " + _UNPORTED)
    ctrl_w, alphas = _control_points(pts3d, w)
    mtm = _build_mtm(alphas, pts2d, w, K)
    V = smallest_subspace(mtm, k=4)
    L, rho = _l6x10_and_rho(V, ctrl_w)
    betas0 = torch.stack([_betas_case1(L, rho), _betas_case2(L, rho),
                          _betas_case3(L, rho)], dim=-2)      # [..., 3, 4]
    betas = _gauss_newton_betas(L[..., None, :, :], rho[..., None, :],
                                betas0, gn_iters)
    Rs, ts = _pose_from_betas(betas, V[..., None, :, :],
                              alphas[..., None, :, :],
                              pts3d[..., None, :, :], w[..., None, :])
    proj = project_points(pts3d[..., None, :, :], Rs, ts,
                          K[..., None, :, :])
    se = ((proj - pts2d[..., None, :, :]) ** 2).sum(-1)
    errs = (se * w[..., None, :]).sum(-1) / torch.clamp_min(
        w.sum(-1), 1e-8)[..., None]
    errs = torch.where(torch.isnan(errs), torch.inf, errs)
    best = torch.argmin(errs, dim=-1)                          # first min
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)
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


def _ransac_prepare(pts3d: torch.Tensor, pts2d: torch.Tensor,
                    w: torch.Tensor, cfg: PnPConfig,
                    prio_u: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Subset build + minimal-set sampling for [B, P] correspondences.

    Returns (sub3d [B,Q,3], sub2d [B,Q,2], sub_w [B,Q], samp3d [B,H,6,3],
    samp2d [B,H,6,2], n_fg [B]); n_fg is the TRUE count of w > 0
    correspondences, for the success gate.
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
    kernel's width 6 by repeating the last draw.
    Returns (samp3d [B, n_hyp, 6, 3], samp2d [B, n_hyp, 6, 2])."""
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
            R2, t2 = epnp(s3, s2, w_in, Kb, cfg.gn_iters)
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


def decode_to_pose_batch(masks, codes, lut_points, lut_valid, bboxes, Ks,
                         bbox_size: int = 128, base: int = 2,
                         cfg: PnPConfig = PnPConfig(),
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[RansacDraws] = None,
                         device=None):
    """masks [B,H,W], codes [B,H,W,n], lut_points [C,3], lut_valid [C],
    bboxes [B,4] (final bbox), Ks [B,3,3] -> (R [B,3,3], t [B,3],
    success [B], n_inliers [B]).

    The hypothesis stage — B·n_hypotheses minimal-set EPnP solves — is
    one launch of the CUDA kernel on CUDA tensors (its plain version on
    CPU tensors). Draws come from `draws` when given, else `generator`
    (a generator on the run's device).
    """
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses
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

    pts3d, orig, fg = _correspondences(masks, codes, lut_points, lut_valid,
                                       bboxes, bbox_size, base)
    sub3d, sub2d, sub_w, samp3d, samp2d, n_fg = _ransac_prepare(
        pts3d, orig, fg, cfg, draws.prio, draws.u, generator)

    def hypotheses(s3, s2):
        B, H = s3.shape[:2]
        Rs, ts = minimal_epnp_hypotheses(
            s3.reshape(B * H, 6, 3).contiguous(),
            s2.reshape(B * H, 6, 2).contiguous(),
            Ks.repeat_interleave(H, dim=0).contiguous(), cfg.gn_iters)
        return Rs.reshape(B, H, 3, 3), ts.reshape(B, H, 3)

    Rs, ts = hypotheses(samp3d, samp2d)
    res = _ransac_finish(sub3d, sub2d, sub_w, Rs, ts, Ks, n_fg, cfg)
    if cfg.escalate_hypotheses <= 0:
        return res
    R1, t1, ok1, n_in1 = res
    needs = _escalation_needed(ok1, n_in1, n_fg, cfg)
    # JAX gates stage 2 for the whole batch with one lax.cond; here the
    # same batch-level gate costs one host sync (needs.any().item()).
    if not bool(needs.any().item()):
        return res
    s3, s2 = _draw_minimal_samples(sub3d, sub2d, sub_w, cfg,
                                   cfg.escalate_hypotheses, draws.u2,
                                   generator)
    Rs2, ts2 = hypotheses(s3, s2)
    R2, t2, ok2, n_in2 = _ransac_finish(sub3d, sub2d, sub_w, Rs2, ts2, Ks,
                                        n_fg, cfg)
    better = needs & (n_in2 > n_in1)
    return (torch.where(better[:, None, None], R2, R1),
            torch.where(better[:, None], t2, t1),
            torch.where(better, ok2, ok1),
            torch.where(better, n_in2, n_in1))
