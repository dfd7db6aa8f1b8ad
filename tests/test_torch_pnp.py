"""Port parity: binarize, small linear algebra, EPnP, the hypothesis
kernel's plain version, the SE(3) polish and the RANSAC sampler of
`zebrapose_tpu_torch` against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through both stacks. JAX's
threefry draws cannot be reproduced in torch, so the sampler tests
derive the uniforms exactly as JAX does and inject them.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.ops import binarize as jbin
from zebrapose_tpu.ops import fast_linalg as jfl
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu.ops.pnp_kernel import minimal_epnp_hypotheses as j_hyp
from zebrapose_tpu_torch.ops import binarize as tbin
from zebrapose_tpu_torch.ops import fast_linalg as tfl
from zebrapose_tpu_torch.ops import pnp as tpnp
from zebrapose_tpu_torch.ops.pnp_kernel import (
    minimal_epnp_hypotheses,
    minimal_epnp_hypotheses_reference,
)

K = np.array([[572.4114, 0, 325.2611],
              [0, 573.57043, 242.04899],
              [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _minimal_sets(n, rng, noise=0.3):
    """tests/test_pnp_kernel.py::_minimal_sets (same draws)."""
    pw = rng.uniform(-40, 40, (n, 6, 3)).astype(np.float32)
    R0 = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(n)])
    R0[np.linalg.det(R0) < 0] *= -1
    t0 = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                         rng.uniform(450, 650, (n, 1))], -1)
    pc = np.einsum("nij,npj->npi", R0, pw) + t0[:, None, :]
    uv = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2],
                   K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]],
                  -1).astype(np.float32)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    return pw, uv, R0.astype(np.float32), t0.astype(np.float32)


def jax_ransac_draws(keys, P, cfg, sample_size=None):
    """The uniforms JAX's decode_to_pose_batch draws for each instance
    key: prio from fold_in(fold_in(key, 2), 3), the minimal-set draws
    from fold_in(key, 2), stage 2 from fold_in(key, 7)."""
    S = sample_size or cfg.sample_size
    prio, u, u2 = [], [], []
    n_pad = tpnp.subset_pad_len(P, cfg)
    for k in keys:
        k2 = jax.random.fold_in(k, 2)
        if n_pad:
            prio.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(k2, 3), (n_pad,))))
        u.append(np.asarray(jax.random.uniform(k2, (cfg.n_hypotheses, S))))
        if cfg.escalate_hypotheses:
            u2.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(k, 7), (cfg.escalate_hypotheses, S))))
    return tpnp.RansacDraws(
        prio=_t(np.stack(prio)) if prio else None, u=_t(np.stack(u)),
        u2=_t(np.stack(u2)) if u2 else None)


# ---------------------------------------------------------------------------
# binarize: exact
# ---------------------------------------------------------------------------

def test_binarize_exact():
    rng = np.random.default_rng(10)
    logits = rng.normal(0, 3, (2, 16, 16, 8)).astype(np.float32)
    logits[0, 0, 0, :4] = [0.0, 1e-9, -1e-9, 0.5]
    np.testing.assert_array_equal(
        tbin.mask_from_logits(_t(logits)).numpy(),
        np.asarray(jbin.mask_from_logits(jnp.asarray(logits))))
    for loss, base in (("BCE", 2), ("L1", 2), ("CE", 2), ("CE", 4)):
        np.testing.assert_array_equal(
            tbin.code_from_logits(_t(logits), loss, base=base).numpy(),
            np.asarray(jbin.code_from_logits(jnp.asarray(logits), loss,
                                             base=base)),
            err_msg=f"{loss}/{base}")


# ---------------------------------------------------------------------------
# fast_linalg: 1e-5 relative
# ---------------------------------------------------------------------------

def _spd(rng, b, n):
    A = rng.normal(size=(b, n, n)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32))


def test_fast_linalg_matches_jax():
    """Each public function plus _inv3/_det3 within 1e-5 relative (f32
    op-order differences only; same algorithm and iteration counts)."""
    rng = np.random.default_rng(11)
    A = _spd(rng, 6, 12)
    Bm = rng.normal(size=(6, 12, 4)).astype(np.float32)
    H = rng.normal(size=(6, 3, 3)).astype(np.float32)
    H[0] *= -1                                   # a det < 0 case
    cases = {
        "cholesky_small": ((A,), {}),
        "solve_psd_small": ((A, Bm), {}),
        "smallest_subspace": ((A,), {"k": 4}),
        "_inv3": ((H,), {}),
        "_det3": ((H,), {}),
        "polar_rotation": ((H,), {}),
        "procrustes_rotation": ((H,), {}),
    }
    for name, (args, kw) in cases.items():
        fn = jax.jit(functools.partial(getattr(jfl, name), **kw))
        want = np.asarray(fn(*map(jnp.asarray, args)))
        got = getattr(tfl, name)(*map(_t, args), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    L = np.asarray(jfl.cholesky_small(jnp.asarray(A)))
    np.testing.assert_allclose(
        tfl.cho_solve_small(_t(L), _t(Bm)).numpy(),
        np.asarray(jfl.cho_solve_small(jnp.asarray(L), jnp.asarray(Bm))),
        rtol=1e-5, atol=1e-6, err_msg="cho_solve_small")


# ---------------------------------------------------------------------------
# minimal-set EPnP: the kernel's plain version vs the JAX reference
# ---------------------------------------------------------------------------

def test_kernel_plain_version_matches_jax():
    """Plain version vs zebrapose_tpu minimal_epnp_hypotheses(use_kernel=
    False), the reference tests/test_pnp_kernel.py holds the Pallas
    kernel against, at its tolerances (R 5e-4, t 0.05)."""
    rng = np.random.default_rng(0)
    n = 24
    pw, uv, R0, _ = _minimal_sets(n, rng, noise=0.3)
    Ks = np.tile(K[None], (n, 1, 1))
    Rj, tj = jax.jit(functools.partial(j_hyp, use_kernel=False))(
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(Ks))
    Rt, tt = minimal_epnp_hypotheses(_t(pw), _t(uv), _t(Ks))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=5e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=0.05)
    assert np.median(np.abs(Rt.numpy() - R0).max((1, 2))) < 0.05
    # the CPU wrapper IS the plain version, and does not count launches
    Rr, _ = minimal_epnp_hypotheses_reference(_t(pw), _t(uv), _t(Ks))
    np.testing.assert_array_equal(Rr.numpy(), Rt.numpy())
    assert minimal_epnp_hypotheses.launches == 0


def test_coincident_minimal_set_gives_zero_rotation_as_in_jax():
    """Six copies of one 3D point (pixels that share a code) have no
    spread: Procrustes gets H = 0 and the polar step returns the zero
    matrix, in the JAX reference as in the port. RANSAC may keep such a
    hypothesis, so a decoded R is orthonormal or exactly zero."""
    rng = np.random.default_rng(14)
    p3 = np.repeat(np.array([[[1.0, 2.0, 3.0]], [[12.5, -3.25, 7.0]],
                             [[13.37, -21.1, 5.55]]], np.float32), 6, axis=1)
    p2 = rng.uniform(200, 300, (3, 6, 2)).astype(np.float32)
    Ks = np.tile(K[None], (3, 1, 1))
    Rj, _ = jax.jit(functools.partial(j_hyp, use_kernel=False))(
        jnp.asarray(p3), jnp.asarray(p2), jnp.asarray(Ks))
    Rt, _ = minimal_epnp_hypotheses(_t(p3), _t(p2), _t(Ks))
    np.testing.assert_array_equal(np.asarray(Rj), 0.0)
    np.testing.assert_array_equal(Rt.numpy(), 0.0)


_J_HYP = {gn: jax.jit(functools.partial(j_hyp, use_kernel=False,
                                        gn_iters=gn)) for gn in (5, 0)}
# Least share of near-degenerate sets on which the plain version and the
# JAX reference agree to R 5e-4 / t 0.05. They are ill-conditioned: two
# f32 op orders of the same algorithm part on some of them, and on many
# more without Gauss-Newton. Shares measured over seeds 0-5 (64 sets
# each): near_collinear 0.91-1.0 with gn_iters=5, 0.14-0.41 with 0;
# near_planar 0.97-1.0 and 0.67-0.84.
_AGREE_FLOOR = {("near_collinear", 5): 0.75, ("near_collinear", 0): 0.1,
                ("near_planar", 5): 0.9, ("near_planar", 0): 0.5}


@pytest.mark.parametrize("kind", ["coincident", "ties", "collinear",
                                  "near_collinear", "near_planar"])
@pytest.mark.parametrize("gn_iters", [5, 0])
def test_kernel_plain_version_on_edge_sets_matches_jax(kind, gn_iters):
    """The kernel's plain version against zebrapose_tpu
    minimal_epnp_hypotheses(use_kernel=False) on the edge sets that
    `chip_smoke.py` holds the kernel to (the cases a split of one solve
    over several threads could break), at the tolerances of
    test_kernel_plain_version_matches_jax (R 5e-4, t 0.05) where the data
    determine the answer:

    coincident  six copies of one point: R is exactly 0 wherever both are
                finite. The depth, hence t, is undetermined and not
                compared.
    ties        coincident sets on which two or three beta cases share
                the least error: the earliest of them wins (its R and t
                exactly), and JAX's R is 0 too.
    collinear   the rotation about the line is undetermined (the two
                stacks part by ~90 degrees at the median): both return
                finite orthonormal rotations.
    near_*      a line with 5 mm of scatter, a plane with 0.5 mm: at
                least the share of sets in _AGREE_FLOOR agrees, and every
                R is orthonormal.
    """
    import chip_smoke

    n = 64
    rng = np.random.default_rng(0)
    pw, uv = chip_smoke.edge_sets("coincident" if kind == "ties" else kind,
                                  n, rng)
    Ks = np.tile(K[None], (n, 1, 1))
    Rj, tj = map(np.asarray, _J_HYP[gn_iters](
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(Ks)))
    Rt, tt = (x.numpy() for x in minimal_epnp_hypotheses(
        _t(pw), _t(uv), _t(Ks), gn_iters))
    if kind == "coincident":
        fin = np.isfinite(Rt).all((1, 2)) & np.isfinite(Rj).all((1, 2))
        assert fin.sum() >= 0.75 * n      # Gauss-Newton on R = 0 can NaN
        np.testing.assert_array_equal(Rt[fin], 0.0)
        np.testing.assert_array_equal(Rj[fin], 0.0)
    elif kind == "ties":
        err, Rs, ts = chip_smoke.case_errors(_t(pw), _t(uv), _t(Ks),
                                             gn_iters)
        err, Rs, ts = err.numpy(), Rs.numpy(), ts.numpy()
        least = err.min(1, keepdims=True)
        tied = ((err == least).sum(1) >= 2) & np.isfinite(least[:, 0])
        assert tied.sum() >= 2
        first = np.argmax(err == least, axis=1)
        rows = np.nonzero(tied)[0]
        np.testing.assert_array_equal(Rt[rows], Rs[rows, first[rows]])
        np.testing.assert_array_equal(tt[rows], ts[rows, first[rows]])
        np.testing.assert_array_equal(Rj[rows], 0.0)
    else:
        for R in (Rt, Rj):
            assert np.isfinite(R).all()
            np.testing.assert_allclose(
                np.einsum("nij,nkj->nik", R, R),
                np.broadcast_to(np.eye(3), R.shape), atol=1e-4)
        if kind != "collinear":
            agree = ((np.abs(Rt - Rj).max((1, 2)) <= 5e-4)
                     & (np.abs(tt - tj).max(1) <= 0.05))
            assert agree.mean() >= _AGREE_FLOOR[kind, gn_iters]


def test_epnp_project_polish_match_jax():
    """Weighted epnp, project_points and the SE(3) polish on noisy,
    partly-outlier correspondences: R within 1e-4, t within 1e-2."""
    rng = np.random.default_rng(12)
    B, N = 3, 60
    pw = rng.uniform(-40, 40, (B, N, 3)).astype(np.float32)
    R0 = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(B)])
    R0[np.linalg.det(R0) < 0] *= -1
    R0 = R0.astype(np.float32)
    t0 = np.array([[5, -3, 600], [-10, 8, 520], [0, 4, 700]], np.float32)
    Ks = np.tile(K[None], (B, 1, 1))
    uv = np.asarray(jax.jit(jax.vmap(jpnp.project_points))(
        jnp.asarray(pw), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(Ks)))
    np.testing.assert_allclose(
        tpnp.project_points(_t(pw), _t(R0), _t(t0), _t(Ks)).numpy(), uv,
        rtol=1e-5, atol=1e-3)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:, :8] += rng.uniform(-40, 40, (B, 8, 2)).astype(np.float32)
    w = (rng.random((B, N)) > 0.2).astype(np.float32)

    Rj, tj = jax.jit(jax.vmap(jpnp.epnp))(
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(w), jnp.asarray(Ks))
    Rt, tt = tpnp.epnp(_t(pw), _t(uv), _t(w), _t(Ks))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-2)

    R1 = (np.asarray(Rj) @ np.asarray(jpnp._so3_exp(
        jnp.asarray([0.01, -0.02, 0.015])))).astype(np.float32)
    Rpj, tpj = jax.jit(jax.vmap(jpnp.gauss_newton_pose_polish))(
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(w), jnp.asarray(Ks),
        jnp.asarray(R1), tj)
    Rpt, tpt = tpnp.gauss_newton_pose_polish(
        _t(pw), _t(uv), _t(w), _t(Ks), _t(R1), _t(tj), 3)
    np.testing.assert_allclose(Rpt.numpy(), np.asarray(Rpj), atol=1e-4)
    np.testing.assert_allclose(tpt.numpy(), np.asarray(tpj), atol=1e-2)


# ---------------------------------------------------------------------------
# RANSAC sampler: identical subsets and minimal sets from the same draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,max_points,sample_size", [
    (1024, 256, 5),     # block-representative subset + exact tail
    (1000, 256, 6),     # P not a multiple of the block count
    (200, 256, 5),      # no subset
])
def test_ransac_sampler_identical_with_injected_draws(P, max_points,
                                                      sample_size):
    rng = np.random.default_rng(13)
    B = 3
    pts3d = rng.uniform(-40, 40, (B, P, 3)).astype(np.float32)
    pts2d = rng.uniform(0, 640, (B, P, 2)).astype(np.float32)
    w = (rng.random((B, P)) > 0.6).astype(np.float32)
    w[2] = 0.0
    w[2, 50:53] = 1.0                             # sparse mask
    cfg = jpnp.PnPConfig(n_hypotheses=16, max_points=max_points,
                         sample_size=sample_size)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = jax.jit(jax.vmap(lambda a, b, c, k: jpnp._ransac_prepare(
        a, b, c, jax.random.fold_in(k, 2), cfg)))(
        jnp.asarray(pts3d), jnp.asarray(pts2d), jnp.asarray(w), keys)
    draws = jax_ransac_draws(keys, P, cfg)
    tcfg = tpnp.PnPConfig(n_hypotheses=16, max_points=max_points,
                          sample_size=sample_size)
    got = tpnp._ransac_prepare(_t(pts3d), _t(pts2d), _t(w), tcfg,
                               prio_u=draws.prio, u=draws.u)
    names = ("sub3d", "sub2d", "sub_w", "samp3d", "samp2d", "n_fg")
    for g, wnt, name in zip(got, want, names):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                      err_msg=name)

    # stage-2 redraw from the subset
    u2 = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(k, 7), (32, sample_size))) for k in keys])
    want2 = jax.jit(jax.vmap(lambda a, b, c, k: jpnp._draw_minimal_samples(
        a, b, c, jax.random.fold_in(k, 7), cfg, 32)))(*want[:3], keys)
    got2 = tpnp._draw_minimal_samples(*got[:3], tcfg, 32, u=_t(u2))
    for g, wnt in zip(got2, want2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_unported_configs_raise():
    """The solver options of ROADMAP A3 are ported and pass the config
    check (tests/test_torch_solvers.py holds them against JAX); what is
    still refused is a solver neither package has."""
    for cfg in (tpnp.PnPConfig(hyp_solver="dlt"),
                tpnp.PnPConfig(fast_linalg=False),
                tpnp.PnPConfig(sample_size=8)):
        tpnp._check_cfg(cfg)
    with pytest.raises(ValueError, match="'epnp' or 'dlt'"):
        tpnp._check_cfg(tpnp.PnPConfig(hyp_solver="p3p"))
