"""Port parity for contour refinement (`cfg.refine`) on the CPU: the
outer border follower against cv2.findContours, the native refiner
against the JAX package's library, `extract_visible_contour` and
`refine_poses` against the JAX runner's, and `run_test` with
`refine = True` against the JAX package's on a tiny BOP tree.

Tolerances and why:
  * border follower: exact (the same contours, in the same order, from
    the same start pixels in the same direction; edge_refine sums its
    normal equations over the points in order).
  * edge_refine, refine_poses: exact, and the debug frames' pixels too:
    both libraries are built from the same source lines by the same
    g++ with the same flags.
  * extract_visible_contour: exact.
  * run_test: R within 1e-4 and t within 1e-2 mm, `success` (a row in
    the CSV) equal, as tests/test_torch_runner.py holds the unrefined
    runner: JAX's RANSAC draws are injected, an oracle forward turns the
    GT crops into logits, and the refiner starts from those poses.
"""

import functools
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_pnp import jax_ransac_draws
from test_torch_runner import (  # noqa: F401  (bop_tree: a fixture)
    _both,
    _cfg_dict,
    _oracle_scene,
    bop_tree,
)
from torch_oracle import ReferenceNet
from zebrapose_tpu import native as jnative
from zebrapose_tpu.config import ZebraConfig as JConfig
from zebrapose_tpu.eval import runner as jrunner
from zebrapose_tpu_torch import native
from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    save_correspondence_lut,
)
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import runner as trunner
from zebrapose_tpu_torch.ops.pnp import PnPConfig

K = np.array([[400.0, 0, 64.0], [0, 400.0, 64.0], [0, 0, 1]])


def _cv2_contours(mask):
    found, _ = cv2.findContours(np.ascontiguousarray(mask, np.uint8),
                                cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    return [c[:, 0, :] for c in found]


def _assert_same_contours(mask):
    got = native.find_external_contours(mask)
    want = _cv2_contours(mask)
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    return len(want)


def _random_mask(rng, i):
    """Seeded masks of four kinds: noise, XORed rectangles (holes, and
    islands in holes), vertically smeared noise (thin strokes) and XORed
    rings (rings one and two pixels thick, nested)."""
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    kind = i % 4
    if kind == 0:
        m = rng.random((h, w)) < rng.uniform(0.05, 0.95)
    elif kind == 1:
        m = np.zeros((h, w), bool)
        for _ in range(rng.integers(1, 6)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1, x1 = y0 + rng.integers(1, 15), x0 + rng.integers(1, 15)
            m[y0:y1, x0:x1] = ~m[y0:y1, x0:x1]
    elif kind == 2:
        m = rng.random((h, w)) < 0.5
        m |= np.roll(m, 1, 0)
    else:
        m = np.zeros((h, w), bool)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(rng.integers(1, 5)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(1, 12))
            d = (yy - y0) ** 2 + (xx - x0) ** 2
            m ^= (d <= r * r) & (d >= (r - int(rng.integers(1, 3))) ** 2)
    return m.astype(np.uint8) * int(rng.integers(1, 256))


def test_border_follower_equals_cv2_on_random_masks():
    rng = np.random.default_rng(70)
    found = sum(_assert_same_contours(_random_mask(rng, i))
                for i in range(320))
    assert found > 1000


def _ring(n, thick, inner=None):
    m = np.zeros((n, n), np.uint8)
    m[1:-1, 1:-1] = 1
    m[1 + thick:-1 - thick, 1 + thick:-1 - thick] = 0
    if inner is not None:
        c = n // 2
        m[c - inner:c + inner + 1, c - inner:c + inner + 1] = 1
    return m


EDGE_CASES = {
    "empty": np.zeros((5, 7), np.uint8),
    "full": np.ones((6, 9), np.uint8),
    "one_pixel_image": np.ones((1, 1), np.uint8),
    "one_row": np.array([[1, 1, 0, 1, 0, 0, 1]], np.uint8),
    "one_column": np.array([[1], [1], [0], [1]], np.uint8),
    "edges_touched": np.pad(np.zeros((4, 4), np.uint8), 1,
                            constant_values=255),
    "corner_pixels": np.array([[1, 0, 0, 1], [0, 0, 0, 0], [1, 0, 0, 1]],
                              np.uint8),
    "one_pixel_blobs": np.kron(np.ones((3, 4), np.uint8),
                               np.array([[0, 0], [0, 1]], np.uint8)),
    "diagonal_join": np.eye(6, dtype=np.uint8) | np.eye(6, k=3,
                                                        dtype=np.uint8),
    "checkerboard": (np.indices((7, 8)).sum(0) % 2).astype(np.uint8),
    "anti_diagonal": np.fliplr(np.eye(5, dtype=np.uint8)),
    "ring_thick_island": _ring(15, 3, inner=1),
    "ring_thin_island": _ring(13, 1, inner=2),
    "ring_thin_empty": _ring(9, 1),
    "nested_rings": _ring(21, 1) | np.pad(_ring(13, 2, inner=1), 4),
    "blob_beside_ring": np.hstack([_ring(11, 2, inner=1),
                                   np.ones((11, 3), np.uint8)]),
    "spiral": np.array([[1, 1, 1, 1, 1, 1],
                        [0, 0, 0, 0, 0, 1],
                        [1, 1, 1, 1, 0, 1],
                        [1, 0, 0, 1, 0, 1],
                        [1, 0, 0, 0, 0, 1],
                        [1, 1, 1, 1, 1, 1]], np.uint8),
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_border_follower_edge_cases_equal_cv2(name):
    n = _assert_same_contours(EDGE_CASES[name])
    if name == "empty":
        assert n == 0
    if name in ("ring_thick_island", "ring_thin_empty", "nested_rings"):
        assert n == 1            # holes, and all they hold, are skipped


def test_border_follower_takes_bool_and_rejects_3d():
    m = EDGE_CASES["checkerboard"].astype(bool)
    assert len(native.find_external_contours(m)) == len(_cv2_contours(m))
    with pytest.raises(ValueError, match="2-D"):
        native.find_external_contours(np.zeros((2, 2, 2)))


# ---------------------------------------------------------------------------
# the refiner
# ---------------------------------------------------------------------------

def _cube():
    s = 25.0
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _sphere():
    v, f = chip_smoke.uv_sphere(30, 36, radius=30.0)
    return v, f.astype(np.int32)


def _refine_case(kind):
    """Mesh, the silhouette contour at the true pose, and a start pose
    off by a rotation about z and a lateral shift (the cube case of
    tests/test_native.py, and the same on a UV sphere)."""
    v, f = _cube() if kind == "cube" else _sphere()
    cls, _ = native.render_label(v, f, np.ones(len(f), np.int32), K,
                                 np.eye(3), np.array([0, 0, 500.0]), 128,
                                 128)
    contour = []
    for y in range(1, 127):
        for x in range(1, 127):
            if cls[y, x] and (cls[y, x - 1] == 0 or cls[y, x + 1] == 0 or
                              cls[y - 1, x] == 0 or cls[y + 1, x] == 0):
                contour.append((x, y))
    th = np.radians(4.0)
    Rp = np.array([[np.cos(th), -np.sin(th), 0],
                   [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    tp = np.array([6.0, -4.0, 500.0])
    return v, f, np.array(contour, np.int32), Rp, tp


@pytest.mark.parametrize("kind", ["cube", "sphere"])
@pytest.mark.parametrize("damp", [(1e2, 1e2), (5e3, 5e5)])
def test_edge_refine_is_bit_equal_to_jax(kind, damp):
    v, f, contour, Rp, tp = _refine_case(kind)
    kw = dict(iterations=12, damp_rot=damp[0], damp_trans=damp[1])
    Rj, tj = jnative.edge_refine(v, f, K, 128, 128, contour, Rp, tp, **kw)
    Rt, tt = native.edge_refine(v, f, K, 128, 128, contour, Rp, tp, **kw)
    assert Rt.dtype == np.float64 and Rt.shape == (3, 3)
    assert tt.dtype == np.float64 and tt.shape == (3,)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    assert not np.array_equal(Rt, Rp)           # the pose moved


def _frames(folder):
    return {n: cv2.imread(os.path.join(folder, n), cv2.IMREAD_UNCHANGED)
            for n in sorted(os.listdir(folder))}


def test_edge_refine_debug_frames_equal_jax(tmp_path):
    v, f, contour, Rp, tp = _refine_case("sphere")
    kw = dict(iterations=4, damp_rot=1e2, damp_trans=1e2)
    Rj, tj = jnative.edge_refine(v, f, K, 128, 128, contour, Rp, tp,
                                 debug_dir=str(tmp_path / "jax"), **kw)
    Rt, tt = native.edge_refine(v, f, K, 128, 128, contour, Rp, tp,
                                debug_dir=str(tmp_path / "port"), **kw)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    want, got = _frames(tmp_path / "jax"), _frames(tmp_path / "port")
    assert sorted(got) == sorted(want) == [f"iter_{i:02d}.png"
                                           for i in range(4)]
    for name in want:
        assert got[name].shape == (128, 128, 3)
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    colors = {tuple(c) for c in got["iter_00.png"].reshape(-1, 3)}
    assert colors == {(0, 0, 0), (96, 96, 96), (0, 255, 0), (0, 0, 255)}


def test_edge_refine_failures_raise_and_stop_the_frames_as_jax(tmp_path):
    v, f, contour, Rp, _ = _refine_case("cube")
    behind = np.array([0.0, 0.0, -500.0])       # nothing renders: code 2
    for mod, sub in ((jnative, "jax"), (native, "port")):
        with pytest.raises(RuntimeError, match="failed: 2"):
            mod.edge_refine(v, f, K, 128, 128, contour, Rp, behind,
                            iterations=3, debug_dir=str(tmp_path / sub))
        with pytest.raises(RuntimeError, match="failed: 1"):
            mod.edge_refine(v, f, K, 128, 128, contour[:2], Rp, behind)
    want, got = _frames(tmp_path / "jax"), _frames(tmp_path / "port")
    assert sorted(got) == sorted(want) == ["iter_00.png"]
    np.testing.assert_array_equal(got["iter_00.png"], want["iter_00.png"])


# ---------------------------------------------------------------------------
# the runner's refinement pass
# ---------------------------------------------------------------------------

def _masks(rng, n, size=64):
    """Entire masks (a disk, or a disk with a bite and a speck) and
    visible masks (the entire mask less a random band)."""
    yy, xx = np.mgrid[0:size, 0:size]
    ent, vis = [], []
    for i in range(n):
        cy, cx = rng.uniform(20, 44, 2)
        r = rng.uniform(8, 18)
        e = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.float32)
        if i % 2:
            e[int(cy):, int(cx):int(cx) + 4] = 0
            e[2, 2] = 1
        v = e.copy()
        lo = int(rng.integers(0, size - 10))
        v[lo:lo + int(rng.integers(3, 20))] = 0
        ent.append(e * rng.uniform(0.6, 1.0))
        vis.append(v)
    return np.array(vis), np.array(ent)


def test_extract_visible_contour_equals_jax():
    vis, ent = _masks(np.random.default_rng(71), 12)
    vis[3] = 0                                 # nothing visible
    ent[4] = 0                                 # no entire mask
    for v, e in zip(vis, ent):
        want = jrunner.extract_visible_contour(e, v)
        got = trunner.extract_visible_contour(e, v)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_refine_poses_equal_jax(bop_tree):  # noqa: F811
    """The same masks and start poses through both runners' pass over
    the tree's three samples: every refined pose bit-equal; one failed
    sample and one with no visible contour are left as they were."""
    je, te = _both(bop_tree, "plain")
    rng = np.random.default_rng(72)
    vis, ent = _masks(rng, 3)
    vis[2] = 0
    v, f = _sphere()
    Rs = np.stack([np.eye(3)] * 3).astype(np.float32)
    th = np.radians(3.0)
    Rs[0] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
             [0, 0, 1]]
    ts = np.array([[1.0, -2.0, 430.0], [-3.0, 1.0, 420.0],
                   [0.0, 0.0, 450.0]], np.float32)
    ok = np.array([True, False, True])
    got = (Rs.copy(), ts.copy())
    want = (Rs.copy(), ts.copy())
    jrunner.refine_poses(je.dataset, *want, ok, vis, ent, v, f, (96, 128),
                         64)
    n = trunner.refine_poses(te.dataset, *got, ok, vis, ent, v, f,
                             (96, 128), 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert n == 1
    assert not np.array_equal(got[1][0], ts[0])
    np.testing.assert_array_equal(got[1][1:], ts[1:])


def test_dataset_image_hw_equals_jax(bop_tree):  # noqa: F811
    je, te = _both(bop_tree, "plain")
    assert trunner.dataset_image_hw(te.samples, te.dataset) == \
        jrunner.dataset_image_hw(je.samples, je.dataset) == (96, 128)


def test_run_inference_collects_masks_and_codes_as_jax(bop_tree,  # noqa: F811
                                                       monkeypatch):
    """collect_masks / collect_codes: the visible and entire masks and
    the codes, fetched a batch late like the poses (b2 over 3 samples:
    a padded tail), equal to the JAX package's."""
    je, te = _both(bop_tree, "plain")
    pts, valid, _ = _oracle_scene(je, monkeypatch)
    from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
    from zebrapose_tpu.eval import evaluate as jev
    from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
    from zebrapose_tpu_torch.eval import evaluate as tev

    kw = dict(crop_img=128, crop_gt=64, base=2, n_bits=16,
              resize_method="crop_square_resize", loss_type="BCE",
              return_masks=True, return_codes=True)
    jstep = _oracle_step(jev.make_eval_step, True)(
        None, JLUT(pts, valid, 2, 16),
        pnp_cfg=JPnP(n_hypotheses=32, max_points=512), **kw)
    tstep = _oracle_step(tev.make_eval_step, False)(
        None, CorrespondenceLUT(pts, valid, 2, 16),
        pnp_cfg=PnPConfig(n_hypotheses=32, max_points=512), device="cpu",
        **kw)
    want = jev.run_inference(je.dataset, jstep, batch_size=2,
                             collect_masks=True, collect_codes=True,
                             num_workers=0)
    got = tev.run_inference(te.dataset, tstep, batch_size=2, device="cpu",
                            collect_masks=True, collect_codes=True)
    assert len(got) == len(want) == 6
    for g, w, shape in zip(got[3:], want[3:], [(3, 64, 64), (3, 64, 64),
                                               (3, 64, 64, 16)]):
        assert g.shape == shape
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3].any() and got[5].any()
    only = tev.run_inference(te.dataset, tstep, batch_size=2, device="cpu",
                             collect_masks=True)
    assert len(only) == 5


def _oracle_step(make, jax_side):
    """make_eval_step with the oracle forward (the GT crops as logits)
    in place of the network, and the GT crops made."""
    def wrapped(forward, *args, **kw):
        kw["preprocess_gt"] = True
        if jax_side:
            def fwd(b, v):
                return {"mask": (b["mask"][..., None] * 2 - 1) * 10,
                        "entire_mask":
                            (b["entire_mask"][..., None] * 2 - 1) * 10,
                        "code": (b["code"] * 2 - 1) * 10}
        else:
            def fwd(b):
                return {"mask": (b["mask"][..., None] * 2 - 1) * 10,
                        "entire_mask":
                            (b["entire_mask"][..., None] * 2 - 1) * 10,
                        "code": (b["code"] * 2 - 1) * 10}
        return make(fwd, *args, **kw)
    return wrapped


def test_run_test_with_refine_matches_jax(bop_tree, tmp_path,  # noqa: F811
                                          monkeypatch):
    """`run_test` with refine = True on the tree (a UV sphere for its
    mesh), port against JAX: an exact-geometry LUT from the crops' GT
    codes, the oracle forward, JAX's draws injected. The poses after
    refinement, the CSV's rows and the metrics."""
    bop_path, _ = bop_tree
    je, _ = _both(bop_tree, "plain")
    pts, valid, _ = _oracle_scene(je, monkeypatch)
    lmo = os.path.join(bop_path, "lmo")
    save_correspondence_lut(
        os.path.join(lmo, "models_GT_color", "Class_CorresPoint000001.txt"),
        CorrespondenceLUT(pts, valid, 2, 16))
    v, f = _sphere()
    from zebrapose_tpu.data.bop_io import save_ply
    for d in ("models", "models_eval"):
        save_ply(os.path.join(lmo, d, "obj_000001.ply"), v, faces=f)
    ckpt = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", 16).state_dict()},
               ckpt)
    d = dict(_cfg_dict(bop_path), refine=True)
    cfg = PnPConfig(n_hypotheses=32, max_points=512)

    from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
    monkeypatch.setattr(jrunner, "make_eval_step",
                        _oracle_step(jrunner.make_eval_step, True))
    jout = str(tmp_path / "jax")
    want = jrunner.run_test(JConfig.from_dict(d), "ape", ckpt, jout,
                            batch_size=2,
                            pnp_cfg=JPnP(n_hypotheses=32, max_points=512))

    def draws_for(start):
        keys = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), start), 2)
        return jax_ransac_draws(keys, 64 * 64, cfg)

    monkeypatch.setattr(trunner, "make_eval_step",
                        _oracle_step(trunner.make_eval_step, False))
    monkeypatch.setattr(trunner, "run_inference", functools.partial(
        trunner.run_inference, draws_for=draws_for))
    refined = []
    refine = trunner.refine_poses
    monkeypatch.setattr(trunner, "refine_poses",
                        lambda *a, **k: refined.append(refine(*a, **k))
                        or refined[-1])
    tout = str(tmp_path / "port")
    got = trunner.run_test(ZebraConfig.from_dict(d), "ape", ckpt, tout,
                           batch_size=2, pnp_cfg=cfg, device="cpu")
    assert refined and refined[0] >= 1          # poses were refined

    def rows(out):
        with open(os.path.join(out, "pose_result_bop", "lmo_ape.csv")) as fh:
            return [r.split(",") for r in fh.read().splitlines()[1:]]

    rt, rj = rows(tout), rows(jout)
    assert [r[:4] for r in rt] == [r[:4] for r in rj] and len(rt) == 3
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(np.array(a[4].split(), float),
                                   np.array(b[4].split(), float), atol=1e-4)
        np.testing.assert_allclose(np.array(a[5].split(), float),
                                   np.array(b[5].split(), float), atol=1e-2)
    assert sorted(got) == sorted(want)
    for k in want:
        if "recall" in k:
            assert got[k] == want[k], k
    for out in (tout, jout):
        log = open(os.path.join(out, "log.txt")).read()
        assert "ADD_recall_0.1d" in log
    assert not os.path.exists(os.path.join(tout, "ADD_result.txt"))
    os.remove(ckpt)


def test_debug_dumps_stay_refused_by_name(bop_tree, tmp_path):  # noqa: F811
    """Debug dumps, once refused by their ROADMAP item (A7), run: with
    refine = True and a random network, `run_test(debug=True)` writes
    the per-sample set under debug/ beside the CSV (tests/
    test_torch_visualize.py holds the set against JAX's)."""
    bop_path, _ = bop_tree
    cfg = ZebraConfig.from_dict(dict(_cfg_dict(bop_path), refine=True))
    ckpt = str(tmp_path / "x.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", 16).state_dict()},
               ckpt)
    out = tmp_path / "o"
    trunner.run_test(cfg, "ape", ckpt, str(out), debug=True, batch_size=2,
                     device="cpu")
    files = set(os.listdir(out / "debug"))
    assert {f"{i:06d}_{k}.png" for i in range(3)
            for k in ("mask", "code_err")} <= files
    assert (out / "pose_result_bop" / "lmo_ape.csv").exists()
    os.remove(ckpt)


# ---------------------------------------------------------------------------
# the fixtures chip_smoke.py holds the port to on the card's machine
# ---------------------------------------------------------------------------

def test_committed_contour_fixture_is_cv2s_and_the_ports():
    fixture = chip_smoke.contour_fixture()
    assert len(fixture) == 48
    for mask, want in fixture:
        now = _cv2_contours(mask)
        assert len(now) == len(want)
        for a, b in zip(now, want):
            np.testing.assert_array_equal(a, b)
        _assert_same_contours(mask)


def test_committed_refine_fixture_is_both_refiners():
    """The committed refined poses are the JAX package's on the
    committed inputs, and the port's are the same bits."""
    v, f = chip_smoke.uv_sphere()
    K_lmo = chip_smoke.K_LMO.astype(np.float64)
    frames = chip_smoke.refine_fixture()
    assert len(frames) == 4
    for fr in frames:
        args = (v, f.astype(np.int32), K_lmo, 640, 480, fr["contour"],
                fr["R0"], fr["t0"])
        Rt, tt = native.edge_refine(*args)
        Rj, tj = jnative.edge_refine(*args)
        for got in ((Rt, tt), (Rj, tj)):
            np.testing.assert_array_equal(got[0], fr["R"])
            np.testing.assert_array_equal(got[1], fr["t"])
        # the refiner pulls the start pose toward the frame's
        assert np.linalg.norm(tt - fr["t_gt"]) < \
            np.linalg.norm(fr["t0"] - fr["t_gt"])


def test_ports_base4_surface_code_is_the_recorded_jax_one(tmp_path):
    """`generate-mesh-code -d 4 -n 8` on the rehearsal sphere writes the
    text whose SHA-256 the manifest records from the JAX package."""
    import hashlib

    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.data.bop_io import save_ply

    v, f = chip_smoke.uv_sphere()
    ply = str(tmp_path / "sphere.ply")
    save_ply(ply, v, faces=f)
    txt = str(tmp_path / "lut.txt")
    assert cli.main(["generate-mesh-code", "--mesh", ply, "-d", "4", "-n",
                     "8", "--corres_txt", txt]) == 0
    with open(txt, "rb") as fh:
        sha = hashlib.sha256(fh.read()).hexdigest()
    assert sha == chip_smoke.refine_manifest()["base4_lut_sha256"]
