"""Iteration-based small linear algebra, batched over leading dims.

Port of `zebrapose_tpu/ops/fast_linalg.py`. The same algorithms, floors
and iteration counts (Cholesky floor 1e-12·max|diag|, k=4 inverse
subspace iteration with 4 iterations, 12-step scaled-Newton polar), so
the batched EPnP built on them (`ops/pnp.py`) is the plain counterpart
of the CUDA hypothesis kernel step for step. `torch.linalg` is not used:
its batched eigh/svd would be a different algorithm.

The three unrolled primitives (`cholesky_small`, `cho_solve_small`,
`polar_rotation`) are `torch.library` ops (`zebrapose::...`; one
implementation for CPU and CUDA, a Meta one for shapes), as
`torch.linalg`'s own factorizations are single ops. Traced by
`torch.export`, each call is one graph node: unrolled, the refits of one
decode made most of a serving program's graph and most of its export
and load time (ROADMAP.md C). Eager calls run the same code, so results
are unchanged. They take no gradients (only the pose solver uses them).
"""

from __future__ import annotations

import torch


def _cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Unrolled lower Cholesky of [..., n, n], pivots floored relative to
    the matrix scale (f32 cancellation can drive a pivot negative)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    diag = A.diagonal(dim1=-2, dim2=-1)
    floor = 1e-12 * torch.clamp_min(diag.abs().amax(-1), 1e-30)
    for j in range(n):
        s = A[..., j, j] - (L[..., j, :j] ** 2).sum(-1)
        d = torch.sqrt(torch.maximum(s, floor))
        L[..., j, j] = d
        if j + 1 < n:
            r = A[..., j + 1:, j] - torch.einsum(
                "...ik,...k->...i", L[..., j + 1:, :j], L[..., j, :j])
            L[..., j + 1:, j] = r / d[..., None]
    return L


def _cho_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L Lᵀ) X = B for B [..., n, m], unrolled."""
    n = L.shape[-1]
    shape = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2]) + B.shape[-2:]
    Y = torch.zeros(shape, dtype=B.dtype, device=B.device)
    for i in range(n):
        acc = B[..., i, :] - torch.einsum(
            "...k,...km->...m", L[..., i, :i], Y[..., :i, :])
        Y[..., i, :] = acc / L[..., i, i][..., None]
    X = torch.zeros_like(Y)
    for i in range(n - 1, -1, -1):
        acc = Y[..., i, :] - torch.einsum(
            "...k,...km->...m", L[..., i + 1:, i], X[..., i + 1:, :])
        X[..., i, :] = acc / L[..., i, i][..., None]
    return X


def solve_psd_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A X = B for small PSD A (batched, unrolled)."""
    return cho_solve_small(cholesky_small(A), B)


def _gram_schmidt(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the k columns of [..., n, k]."""
    cols = []
    for i in range(Y.shape[-1]):
        v = Y[..., i]
        for u in cols:
            v = v - (v * u).sum(-1, keepdim=True) * u
        nrm = torch.sqrt((v * v).sum(-1, keepdim=True))
        cols.append(v / torch.clamp_min(nrm, 1e-20))
    return torch.stack(cols, dim=-1)


def smallest_subspace(A: torch.Tensor, k: int = 4,
                      iters: int = 4) -> torch.Tensor:
    """[..., n, n] PSD -> [..., n, k] orthonormal basis of the bottom-k
    eigen-subspace, columns in ascending Rayleigh-quotient order.

    Inverse (Cholesky) subspace iteration on the trace-normalized,
    1e-6-regularized matrix; one factorization reused across iterations.
    """
    n = A.shape[-1]
    tr = A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    s0 = torch.clamp_min(tr / n, 1e-30)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    chol = cholesky_small(A / s0 + 1e-6 * eye)
    Y0 = torch.eye(n, k, dtype=A.dtype, device=A.device) + 0.01
    Y = Y0.expand(A.shape[:-2] + (n, k))
    for _ in range(iters):
        Y = _gram_schmidt(cho_solve_small(chol, Y))
    rq = (Y * (A @ Y)).sum(-2)                         # [..., k]
    order = torch.argsort(rq, dim=-1, stable=True)
    return torch.gather(Y, -1, order[..., None, :].expand(Y.shape))


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det), batch dims broadcast."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-20,
                      _sign(det) * 1e-20 + (det == 0) * 1e-20, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant, batch dims broadcast."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign semantics: NaN stays NaN (torch.sign maps it to 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _polar_rotation(H: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """[..., 3, 3] -> closest proper rotation by scaled Newton polar
    iteration X <- (γX + X⁻ᵀ/γ)/2; for det(H) < 0 the last row is
    flipped first."""
    flip = torch.where(_det3(H) < 0, -1.0, 1.0)[..., None, None]
    sign_fix = torch.cat([torch.ones_like(H[..., :2, :]),
                          flip.expand(H[..., 2:3, :].shape)], dim=-2)
    X = H * sign_fix
    norm = torch.sqrt((X * X).sum((-2, -1), keepdim=True))
    X = X / torch.clamp_min(norm, 1e-20)
    for _ in range(iters):
        Xinv_t = _inv3(X).transpose(-1, -2)
        gamma = _det3(X).abs()[..., None, None]
        gamma = torch.pow(torch.clamp_min(gamma, 1e-20), -1.0 / 3.0)
        X = 0.5 * (gamma * X + Xinv_t / gamma)
    return X


def procrustes_rotation(H: torch.Tensor) -> torch.Tensor:
    """Rotation maximizing trace(Rᵀ H): the polar factor of H."""
    return polar_rotation(H)


# the ops (see the module docstring); a Library fragment, as
# `ops/pnp_kernel.py` defines its op, so that importing this module
# inspects no other module
_OPS = torch.library.Library("zebrapose", "FRAGMENT")
for _name, _impl, _meta, _schema in (
        ("cholesky_small", _cholesky_small, lambda A: torch.empty_like(A),
         "(Tensor A) -> Tensor"),
        ("cho_solve_small", _cho_solve_small,
         lambda L, B: B.new_empty(torch.broadcast_shapes(
             L.shape[:-2], B.shape[:-2]) + B.shape[-2:]),
         "(Tensor L, Tensor B) -> Tensor"),
        ("polar_rotation", _polar_rotation,
         lambda H, iters=12: torch.empty_like(H),
         "(Tensor H, int iters=12) -> Tensor")):
    _OPS.define(_name + _schema)
    _OPS.impl(_name, _impl, "CPU")
    _OPS.impl(_name, _impl, "CUDA")
    _OPS.impl(_name, _meta, "Meta")

cholesky_small = torch.ops.zebrapose.cholesky_small
cho_solve_small = torch.ops.zebrapose.cho_solve_small
polar_rotation = torch.ops.zebrapose.polar_rotation
