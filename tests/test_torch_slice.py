"""Port parity for the whole inference slice on the CPU:
`decode_to_pose_batch` and `make_eval_step` of `zebrapose_tpu_torch`
against the JAX package, with JAX's RANSAC draws injected into the port.

Scenes: minimal sets drawn from purely random correspondences are
ill-conditioned, and their EPnP solutions are chaotic in float32 (even
two XLA builds of the JAX program disagree on them), so the end-to-end
comparisons run on scenes whose codes encode a real pose (noise-free
views of a relief surface) plus outlier pixels. The random-code decode
inputs of tests/test_pnp_kernel.py are held through the deterministic
part of RANSAC: the same hypotheses must give the same result.

Tolerances and why:
  * R within 1e-4, `success` and `n_inliers` equal: with the same draws
    both stacks run the same algorithm in float32; only op order differs
    (JAX's own decode test holds two JAX paths to 1e-4).
  * t within 1e-2 mm (~600 mm depth: ~2e-5 relative) on the relief
    scenes. On random codes the refit rests on a few inliers at random
    3D points and its depth is ill-conditioned: JAX's own eager and
    jitted runs of that `_ransac_finish` differ by 0.38 mm at 770 mm
    depth, so there t is held to 1e-3 of its norm.
  * preprocessed image within 1e-4: the crop is a gather here and two
    interpolation-matrix matmuls in JAX (~1 ulp at u8 scale, divided by
    255·std).
  * logits within 2e-4: the float32 forward tolerance of
    tests/test_model_parity.py.
  * hard masks / codes equal on >= 99.9 % of pixels: a logit within 2e-4
    of 0 may binarize differently; poses are compared on the instances
    whose hard outputs agree bit for bit (others see other inputs).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_model import flax_variables
from test_torch_pnp import jax_ransac_draws
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.eval.evaluate import _pad_to as j_pad_to
from zebrapose_tpu.eval.evaluate import make_eval_step as j_make_eval_step
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu.ops.binarize import code_from_logits as j_code
from zebrapose_tpu.ops.pnp_kernel import minimal_epnp_hypotheses as j_hyp
from zebrapose_tpu.ops.roi import (
    final_bbox,
    map_pixels_to_original,
    square_bbox,
)
from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.eval.evaluate import _pad_to, make_eval_step
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops import pnp as tpnp

K = np.array([[572.4114, 0, 325.2611],
              [0, 573.57043, 242.04899],
              [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotation(rng):
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return R * np.sign(np.linalg.det(R))


def _scene_lut(ids, fbs, size, n_ids, rows, rng):
    """LUT [n_ids] making the FIRST pixel of each class id (per row of
    `ids` [B, size*size]) a noise-free view, through the row's final
    bbox, of a relief surface under a per-row pose; later pixels sharing
    an id are outliers. Returns (points, valid, R_gt [B], t_gt [B])."""
    pts = np.zeros((n_ids, 3), np.float32)
    valid = np.zeros((n_ids,), bool)
    Kinv = np.linalg.inv(K.astype(np.float64))
    pix = np.arange(size * size)
    px = np.stack([pix % size, pix // size], -1).astype(np.int32)
    R_gt, t_gt = [], []
    for b in range(ids.shape[0]):
        R0, t0 = _rotation(rng), np.array([0.0, 0.0, 600.0])
        R_gt.append(R0)
        t_gt.append(t0)
        if b not in rows:
            continue
        orig = np.asarray(map_pixels_to_original(
            jnp.asarray(px), jnp.asarray(fbs[b]), size))
        for p, cid in enumerate(ids[b]):
            if valid[cid]:
                continue
            ox, oy = orig[p]
            d = 600.0 + 40 * np.sin(0.3 * ox) * np.cos(0.25 * oy)
            pts[cid] = R0.T @ (Kinv @ np.array([ox * d, oy * d, d]) - t0)
            valid[cid] = True
    return pts, valid, np.array(R_gt), np.array(t_gt)


def _bits(ids, n_bits):
    shifts = np.arange(n_bits - 1, -1, -1)
    return ((ids[..., None] >> shifts) & 1).astype(np.float32)


def _assert_poses(got, want, rows=None, t_rtol=0.0):
    names = ("R", "t", "success", "n_inliers")
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    if rows is not None:
        got = [g[rows] for g in got]
        want = [w[rows] for w in want]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, err_msg="R")
    t_tol = 1e-2 + t_rtol * np.linalg.norm(want[1], axis=-1, keepdims=True)
    assert (np.abs(got[1] - want[1]) <= t_tol).all(), ("t", got[1], want[1])
    for i in (2, 3):
        np.testing.assert_array_equal(got[i], want[i], err_msg=names[i])


def _decode_scene():
    """The decode shapes of tests/test_pnp_kernel.py (B=3, 32², 10 bits,
    16x16 masks, bbox (100, 80, 64, 64)); each instance's fg pixels carry
    their own ids on a relief scene, 30 % replaced by random codes."""
    rng = np.random.default_rng(1)
    B, hw, n_bits = 3, 32, 10
    masks = np.zeros((B, hw, hw), np.float32)
    masks[:, 8:24, 8:24] = 1.0
    bboxes = np.tile(np.array([[100, 80, 64, 64]], np.int32), (B, 1))
    ids = np.zeros((B, hw * hw), np.int64)
    fg = np.flatnonzero(masks[0].reshape(-1))
    for b in range(B):
        ids[b, fg] = 1 + 300 * b + np.arange(fg.size)
    lut_pts, lut_valid, R_gt, _ = _scene_lut(ids, bboxes, hw, 2 ** n_bits,
                                             range(B), rng)
    out = rng.random(ids.shape) < 0.3
    ids[out] = rng.integers(0, 2 ** n_bits, out.sum())
    codes = _bits(ids.reshape(B, hw, hw), n_bits)
    Ks = np.tile(K[None], (B, 1, 1))
    return masks, codes, lut_pts, lut_valid, bboxes, Ks, hw, R_gt


@pytest.mark.parametrize("escalate", [0, 32])
def test_decode_to_pose_batch_matches_jax(escalate):
    masks, codes, lut_pts, lut_valid, bboxes, Ks, hw, R_gt = _decode_scene()
    B = masks.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    kw = dict(n_hypotheses=16, max_points=256,
              escalate_hypotheses=escalate)
    want = jpnp.decode_to_pose_batch(
        jnp.asarray(masks), jnp.asarray(codes), jnp.asarray(lut_pts),
        jnp.asarray(lut_valid), jnp.asarray(bboxes), jnp.asarray(Ks), keys,
        bbox_size=hw, cfg=jpnp.PnPConfig(**kw), use_kernel=False)
    cfg = tpnp.PnPConfig(**kw)
    if escalate:
        # the subset's inlier support is below 0.4·n_fg: stage 2 runs
        needs = tpnp._escalation_needed(_t(want[2]), _t(want[3]),
                                        torch.full((B,), 256), cfg)
        assert bool(needs.all())
    got = tpnp.decode_to_pose_batch(
        masks, codes, lut_pts, lut_valid, bboxes, Ks, bbox_size=hw,
        cfg=cfg, draws=jax_ransac_draws(keys, hw * hw, cfg), device="cpu")
    _assert_poses(got, want)
    assert got[2].all()
    ang = np.degrees(np.arccos(np.clip(
        (np.einsum("bij,bij->b", got[0].numpy(), R_gt) - 1) / 2, -1, 1)))
    assert ang.max() < 0.5, ang


def test_ransac_finish_on_random_codes_matches_jax():
    """tests/test_pnp_kernel.py's random-code decode inputs: with the
    same subsets and the same hypotheses, scoring, refit, polish and the
    success gate agree."""
    rng = np.random.default_rng(1)
    B, hw, n_bits = 3, 32, 10
    lut_pts = rng.uniform(-40, 40, (2 ** n_bits, 3)).astype(np.float32)
    lut_valid = np.ones((2 ** n_bits,), bool)
    masks = np.zeros((B, hw, hw), np.float32)
    masks[:, 8:24, 8:24] = 1.0
    codes = rng.integers(0, 2, (B, hw, hw, n_bits)).astype(np.float32)
    bboxes = np.tile(np.array([[100, 80, 64, 64]], np.int32), (B, 1))
    Ks = np.tile(K[None], (B, 1, 1))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jcfg = jpnp.PnPConfig(n_hypotheses=16, max_points=256)
    cfg = tpnp.PnPConfig(n_hypotheses=16, max_points=256)

    def prep(mask, code, bbox, key):
        p3, p2, fg = jpnp._correspondences(
            mask, code, jnp.asarray(lut_pts), jnp.asarray(lut_valid), bbox,
            hw, 2)
        return jpnp._ransac_prepare(p3, p2, fg, jax.random.fold_in(key, 2),
                                    jcfg)

    J = jax.jit(jax.vmap(prep))(jnp.asarray(masks), jnp.asarray(codes),
                                jnp.asarray(bboxes), keys)
    draws = jax_ransac_draws(keys, hw * hw, cfg)
    T = tpnp._ransac_prepare(*tpnp._correspondences(
        _t(masks), _t(codes), _t(lut_pts), _t(lut_valid), _t(bboxes), hw, 2),
        cfg, draws.prio, draws.u)
    for g, w in zip(T, J):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    Rs, ts = jax.jit(functools.partial(j_hyp, use_kernel=False))(
        J[3].reshape(-1, 6, 3), J[4].reshape(-1, 6, 2),
        jnp.repeat(jnp.asarray(Ks), 16, axis=0))
    Rs, ts = Rs.reshape(B, 16, 3, 3), ts.reshape(B, 16, 3)
    want = jax.jit(jax.vmap(lambda a, b, c, d, e, f, g: jpnp._ransac_finish(
        a, b, c, d, e, f, g, jcfg)))(J[0], J[1], J[2], Rs, ts,
                                     jnp.asarray(Ks), J[5])
    got = tpnp._ransac_finish(T[0], T[1], T[2], _t(Rs), _t(ts), _t(Ks),
                              T[5], cfg)
    _assert_poses(got, want, t_rtol=1e-3)


def _frames(B, rng):
    """Synthetic 480x640 BGR frames with an object-ish blob, bboxes
    through the host bbox math, final bboxes and K."""
    rgb = rng.integers(0, 256, (B, 480, 640, 3), dtype=np.uint8)
    bboxes = [(200, 150, 90, 120), (-20, -10, 110, 90), (560, 400, 120, 100)]
    params, fbs = [], []
    for bb in bboxes[:B]:
        x1, y1, x2, y2, side = square_bbox(np.array(bb))
        params.append([x1, y1, x2, y2, max(side, 1)])
        fbs.append(final_bbox(np.array(bb), "crop_square_resize", 640, 480))
    raw = {"rgb": rgb,
           "label": np.zeros((B, 480, 640, 3), np.uint8),
           "mask": np.zeros((B, 480, 640), np.uint8),
           "entire_mask": np.zeros((B, 480, 640), np.uint8),
           "roi_param": np.array(params, np.int32),
           "valid": np.array([1.0] * (B - 1) + [0.0], np.float32)}
    return raw, np.array(fbs, np.int32), np.tile(K[None], (B, 1, 1))


def test_make_eval_step_matches_jax():
    """The whole slice: raw frames -> crop -> v2 net -> binarize ->
    decode -> RANSAC, JAX vs port, same weights and draws. The LUT turns
    the network's own hard codes into a relief scene (see _scene_lut);
    the mask head's bias is raised so every crop pixel is foreground."""
    B, crop_img, crop_gt, n_bits = 3, 64, 32, 16
    rng = np.random.default_rng(30)
    variables = flax_variables("v2", rng)
    head = variables["params"]["aspp"]["conv_1x1_4"]["conv"]
    head["bias"] = head["bias"].copy()
    head["bias"][0] = 20.0
    raw, fb, Ks = _frames(B, rng)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    key = jax.random.PRNGKey(11)
    jmodel = JNet(binary_code_length=n_bits, variant="v2")
    jimage = j_preprocess(jraw, key, crop_img=crop_img, crop_gt=crop_gt,
                          is_train=False, include_gt=False)["image"]
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jimage)
    ids = (np.asarray(j_code(jout["code"])).reshape(B, -1, n_bits)
           @ (2 ** np.arange(n_bits - 1, -1, -1))).astype(np.int64)
    lut_pts, lut_valid, _, _ = _scene_lut(ids, fb, crop_gt, 2 ** n_bits,
                                          (0, 1), rng)

    # H=64: a clean minimal set is all but certain at ~70 % inliers, so
    # the compared poses are converged ones, not weak-consensus fits
    kw = dict(n_hypotheses=64, max_points=256)
    common = dict(crop_img=crop_img, crop_gt=crop_gt, base=2,
                  n_bits=n_bits, resize_method="crop_square_resize",
                  loss_type="BCE", return_masks=True, return_codes=True,
                  preprocess_gt=False)
    jstep = j_make_eval_step(
        lambda b, v: jmodel.apply(v, b["image"], train=False),
        JLUT(lut_pts, lut_valid, 2, n_bits),
        pnp_cfg=jpnp.PnPConfig(**kw), use_kernel=False, **common)
    want = jstep(jraw, jnp.asarray(fb), jnp.asarray(Ks), key, variables)

    model = ZebraPoseNet(binary_code_length=n_bits, variant="v2").eval()
    model.load_state_dict(variables_to_state_dict(variables, "v2"))
    tout = {}

    def tforward(batch):
        out = model(batch["image"])
        tout.update(image=batch["image"], **out)
        return out

    cfg = tpnp.PnPConfig(**kw)
    step = make_eval_step(tforward, CorrespondenceLUT(lut_pts, lut_valid,
                                                      2, n_bits),
                          pnp_cfg=cfg, device="cpu", **common)
    keys = jax.random.split(key, B)
    got = step(raw, fb, Ks, draws=jax_ransac_draws(keys, crop_gt ** 2, cfg))

    np.testing.assert_allclose(tout["image"].numpy(), np.asarray(jimage),
                               atol=1e-4)
    for name in ("mask", "entire_mask", "code"):
        np.testing.assert_allclose(tout[name].numpy(),
                                   np.asarray(jout[name]), atol=2e-4,
                                   err_msg=name)
    hard_same = []
    for g, w in zip(got[4:], want[4:]):          # masks, entire, codes
        g, w = g.numpy(), np.asarray(w)
        assert np.mean(g == w) >= 0.999
        hard_same.append((g == w).reshape(B, -1).all(-1))
    rows = np.logical_and.reduce(hard_same)
    assert got[2].numpy()[rows].any()            # a real pose is compared
    _assert_poses(got[:4], want[:4], rows)
    # the dummy sample (valid = 0) has no foreground and fails
    assert not bool(got[2][-1]) and int(got[3][-1]) == 0


def test_pad_to_matches_jax():
    rng = np.random.default_rng(31)
    arrs = {"rgb": rng.integers(0, 256, (3, 4, 5, 3), dtype=np.uint8),
            "valid": np.ones(3, np.float32)}
    for size in (3, 8):
        got, want = _pad_to(arrs, size), j_pad_to(arrs, size)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
