"""Port parity for the RANSAC solver options on the CPU, against the JAX
package: `dlt_p6p` (fast True and False), `epnp(fast=False)`,
`ransac_pnp`, `decode_to_pose`, and `decode_to_pose_batch` with
`hyp_solver="dlt"`, `fast_linalg=False` and `sample_size=8`, plain and
escalated, JAX's RANSAC draws injected.

Tolerances and why:
  * minimal-set solvers (`dlt_p6p`, `epnp(fast=False)` on 6 points):
    the kernel parity tolerances of tests/test_torch_pnp.py (R 5e-4,
    t 0.05) do not apply, because these solvers are not that well
    conditioned in float32. The unnormalized 12x12 DLT system puts the
    null vector that eigh returns ~4e-3 (median) from its float64 value
    on 0.3 px noisy sets and ~0.45 on near-planar ones, in JAX as in the
    port, and a few EPnP sets with nearly equal small eigenvalues of MᵀM
    move by ~1e-2. So each stack is held to JAX's own float64 answer: a
    set agrees when the port's float32 R and t lie within max(5e-4,
    4 x JAX float32's distance) and max(0.05, 4 x ...) of it; at least
    the share in _AGREE_FLOOR agrees (measured over seeds 0-2), and the
    port's median distance is at most 3x JAX's (+1e-6).
  * whole decodes on exact-geometry relief scenes (the scenes of
    tests/test_torch_slice.py): R within 1e-4, t within 1e-2 mm,
    `success` and `n_inliers` equal, as there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_pnp import _minimal_sets, jax_ransac_draws
import test_torch_slice
from test_torch_slice import K, _assert_poses
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu_torch.ops import pnp as tpnp
from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax(fn, args, x64=False):
    dt = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        out = jax.jit(jax.vmap(fn))(*[jnp.asarray(a, dt) for a in args])
        return [np.asarray(o, np.float64) for o in out]


_SOLVERS = {
    "dlt_fast": (lambda a, b, k: jpnp.dlt_p6p(a, b, k, True),
                 lambda a, b, k: tpnp.dlt_p6p(a, b, k, True)),
    "dlt_eigh": (lambda a, b, k: jpnp.dlt_p6p(a, b, k, False),
                 lambda a, b, k: tpnp.dlt_p6p(a, b, k, False)),
    "epnp_eigh": (lambda a, b, k: jpnp.epnp(a, b, jnp.ones(a.shape[0],
                                                          a.dtype), k, 5,
                                            False),
                  lambda a, b, k: tpnp.epnp(a, b, torch.ones_like(a[..., 0]),
                                            k, 5, False)),
}
# least share of sets agreeing (see the module docstring); measured
# shares over seeds 0-2 in brackets
_AGREE_FLOOR = {("dlt_fast", "noisy"): 0.85,          # 0.94-0.98
                ("dlt_fast", "near_planar"): 0.9,     # 0.98-1.0
                ("dlt_eigh", "noisy"): 0.65,          # 0.77-0.78
                ("dlt_eigh", "near_planar"): 0.7,     # 0.83-0.86
                ("epnp_eigh", "noisy"): 0.5,          # 0.63-0.84
                ("epnp_eigh", "near_planar"): 0.9}    # 1.0


@pytest.mark.parametrize("kind", ["noisy", "near_planar"])
@pytest.mark.parametrize("solver", sorted(_SOLVERS))
def test_minimal_solvers_match_jax(solver, kind):
    n = 64
    rng = np.random.default_rng(0)
    if kind == "noisy":
        pw, uv, _, _ = _minimal_sets(n, rng, noise=0.3)
    else:
        pw, uv = chip_smoke.edge_sets(kind, n, rng)
    Ks = np.tile(K[None], (n, 1, 1))
    jfn, tfn = _SOLVERS[solver]
    Rj, tj = _jax(jfn, (pw, uv, Ks))
    R64, t64 = _jax(jfn, (pw, uv, Ks), x64=True)
    Rt, tt = (x.numpy().astype(np.float64) for x in tfn(_t(pw), _t(uv),
                                                         _t(Ks)))
    assert np.isfinite(Rt).all() and np.isfinite(tt).all()
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", Rt, Rt),
                               np.broadcast_to(np.eye(3), Rt.shape),
                               atol=1e-4)
    ej, et = np.abs(Rj - R64).max((1, 2)), np.abs(Rt - R64).max((1, 2))
    ejt, ett = np.abs(tj - t64).max(1), np.abs(tt - t64).max(1)
    agree = (et <= np.maximum(5e-4, 4 * ej)) & \
        (ett <= np.maximum(0.05, 4 * ejt))
    assert agree.mean() >= _AGREE_FLOOR[solver, kind], agree.mean()
    assert np.median(et) <= 3 * np.median(ej) + 1e-6
    assert np.median(ett) <= 3 * np.median(ejt) + 1e-6


def test_epnp_eigh_on_weighted_sets_matches_jax():
    """epnp(fast=False) on 60 weighted correspondences with outliers (the
    case of tests/test_torch_pnp.py::test_epnp_project_polish_match_jax):
    well conditioned, R within 1e-4 and t within 1e-2."""
    rng = np.random.default_rng(12)
    B, N = 3, 60
    pw = rng.uniform(-40, 40, (B, N, 3)).astype(np.float32)
    R0, t0 = chip_smoke.random_poses(B, rng)
    Ks = np.tile(K[None], (B, 1, 1))
    uv = chip_smoke.project(pw, R0, t0)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:, :8] += rng.uniform(-40, 40, (B, 8, 2)).astype(np.float32)
    w = (rng.random((B, N)) > 0.2).astype(np.float32)
    Rj, tj = jax.jit(jax.vmap(lambda a, b, c, k: jpnp.epnp(
        a, b, c, k, 5, False)))(*map(jnp.asarray, (pw, uv, w, Ks)))
    Rt, tt = tpnp.epnp(_t(pw), _t(uv), _t(w), _t(Ks), 5, fast=False)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-2)


def _relief_scene(depth_amp, box=64):
    """test_torch_slice._decode_scene (B=3, 32², 10 bits, 16x16 masks,
    30 % outlier codes) on a relief of ±depth_amp mm at 600 mm:
    test_torch_slice's ±40 for the EPnP options; DLT's 12-dof fit needs
    more 3D spread (on ±40 it fails every instance in both stacks)."""
    from zebrapose_tpu.ops.roi import map_pixels_to_original

    rng = np.random.default_rng(1)
    B, hw, n_bits = 3, 32, 10
    masks = np.zeros((B, hw, hw), np.float32)
    masks[:, 8:24, 8:24] = 1.0
    bboxes = np.tile(np.array([[100, 80, box, box]], np.int32), (B, 1))
    pts = np.zeros((2 ** n_bits, 3), np.float32)
    valid = np.zeros((2 ** n_bits,), bool)
    ids = np.zeros((B, hw * hw), np.int64)
    fg = np.flatnonzero(masks[0].reshape(-1))
    pix = np.arange(hw * hw)
    orig = np.asarray(map_pixels_to_original(
        jnp.asarray(np.stack([pix % hw, pix // hw], -1).astype(np.int32)),
        jnp.asarray(bboxes[0]), hw))
    Kinv = np.linalg.inv(K.astype(np.float64))
    R_gt = []
    for b in range(B):
        R0 = test_torch_slice._rotation(rng)
        R_gt.append(R0)
        for i, p in enumerate(fg):
            cid = 1 + 300 * b + i
            ox, oy = orig[p]
            d = 600.0 + depth_amp * np.sin(0.3 * ox) * np.cos(0.25 * oy)
            pts[cid] = R0.T @ (Kinv @ np.array([ox * d, oy * d, d])
                               - np.array([0.0, 0.0, 600.0]))
            valid[cid] = True
            ids[b, p] = cid
    out = rng.random(ids.shape) < 0.3
    ids[out] = rng.integers(0, 2 ** n_bits, out.sum())
    codes = test_torch_slice._bits(ids.reshape(B, hw, hw), n_bits)
    return (masks, codes, pts, valid, bboxes, np.tile(K[None], (B, 1, 1)),
            hw, np.array(R_gt))


# DLT with sample_size 6: the default 5 pads each set to 6 by repeating a
# draw, which leaves DLT's 11-dof system a 2-d null space (both stacks
# then fail every instance)
_OPTIONS = {"dlt": dict(hyp_solver="dlt", sample_size=6),
            "eigh": dict(fast_linalg=False),
            "sample8": dict(sample_size=8)}
# the relief (depth amplitude, bbox side) of each option's scenes: the
# shallow, narrow one of test_torch_slice for the EPnP options; for DLT
# a deep, wide one, since float32 DLT fails on narrow views in both
# stacks (its 12x12 system's eigenvalues span ~1e11 at a 64-pixel bbox)
_SCENE = {"dlt": (200.0, 384), "eigh": (40.0, 64), "sample8": (40.0, 64)}


@pytest.mark.parametrize("escalate", [0, 32])
@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_decode_to_pose_batch_options_match_jax(option, escalate):
    """Relief scenes with 30 % outlier codes (`_relief_scene`), each
    option against JAX's decode_to_pose_batch with its draws injected;
    none of them launches the hypothesis kernel (JAX leaves its Pallas
    kernel for these too)."""
    masks, codes, lut_pts, lut_valid, bboxes, Ks, hw, R_gt = _relief_scene(
        *_SCENE[option])
    B = masks.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    kw = dict(n_hypotheses=16, max_points=256,
              escalate_hypotheses=escalate, **_OPTIONS[option])
    want = jpnp.decode_to_pose_batch(
        jnp.asarray(masks), jnp.asarray(codes), jnp.asarray(lut_pts),
        jnp.asarray(lut_valid), jnp.asarray(bboxes), jnp.asarray(Ks), keys,
        bbox_size=hw, cfg=jpnp.PnPConfig(**kw), use_kernel=False)
    cfg = tpnp.PnPConfig(**kw)
    if escalate:
        needs = tpnp._escalation_needed(_t(want[2]), _t(want[3]),
                                        torch.full((B,), 256), cfg)
        assert bool(needs.all())
    got = tpnp.decode_to_pose_batch(
        masks, codes, lut_pts, lut_valid, bboxes, Ks, bbox_size=hw,
        cfg=cfg, draws=jax_ransac_draws(keys, hw * hw, cfg), device="cpu")
    _assert_poses(got, want)
    assert got[2].all()
    ang = chip_smoke.rot_deg(got[0].numpy().astype(np.float64), R_gt)
    assert ang.max() < 0.5, ang
    assert minimal_epnp_hypotheses.launches == 0


def _single_draws(key, P, cfg):
    """The uniforms JAX's ransac_pnp draws from its key: prio from
    fold_in(key, 3), the minimal sets from key, stage 2 from
    fold_in(key, 7); one instance's shapes."""
    n_pad = tpnp.subset_pad_len(P, cfg)
    S = cfg.sample_size
    return tpnp.RansacDraws(
        prio=_t(jax.random.uniform(jax.random.fold_in(key, 3), (n_pad,)))
        if n_pad else None,
        u=_t(jax.random.uniform(key, (cfg.n_hypotheses, S))),
        u2=_t(jax.random.uniform(jax.random.fold_in(key, 7),
                                 (cfg.escalate_hypotheses, S)))
        if cfg.escalate_hypotheses else None)


@pytest.mark.parametrize("kw", [{}, {"escalate_hypotheses": 32}])
def test_ransac_pnp_and_decode_to_pose_match_jax(kw):
    """The single-instance entry points on one relief instance: JAX's
    decode_to_pose folds 2 into its key and hands it to ransac_pnp, whose
    draws are injected here; ransac_pnp is called on the same instance's
    correspondences directly."""
    masks, codes, lut_pts, lut_valid, bboxes, Ks, hw, R_gt = _relief_scene(
        *_SCENE["eigh"])
    kw = dict(n_hypotheses=16, max_points=256, **kw)
    jcfg, cfg = jpnp.PnPConfig(**kw), tpnp.PnPConfig(**kw)
    b = 1
    key = jax.random.PRNGKey(20)
    args = (masks[b], codes[b], lut_pts, lut_valid, bboxes[b], Ks[b])
    want = _J_DECODE(*map(jnp.asarray, args), key, bbox_size=hw, cfg=jcfg)
    got = tpnp.decode_to_pose(
        *args, bbox_size=hw, cfg=cfg, device="cpu",
        draws=_single_draws(jax.random.fold_in(key, 2), hw * hw, cfg))
    _assert_poses([g[None] for g in got], [np.asarray(w)[None] for w in want])
    assert bool(got[2])
    assert chip_smoke.rot_deg(got[0].numpy()[None].astype(np.float64),
                              R_gt[b:b + 1]).max() < 0.5

    p3, p2, fg = jpnp._correspondences(*map(jnp.asarray, args[:5]), hw, 2)
    want = _J_RANSAC(p3, p2, fg, jnp.asarray(Ks[b]), key, cfg=jcfg)
    got = tpnp.ransac_pnp(np.array(p3), np.array(p2), np.array(fg), Ks[b],
                          cfg, device="cpu",
                          draws=_single_draws(key, hw * hw, cfg))
    _assert_poses([g[None] for g in got], [np.asarray(w)[None] for w in want])
    assert bool(got[2])


_J_DECODE = jax.jit(jpnp.decode_to_pose,
                    static_argnames=("bbox_size", "cfg", "base"))
_J_RANSAC = jax.jit(jpnp.ransac_pnp, static_argnames=("cfg",))
