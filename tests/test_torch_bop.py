"""Port parity for BOP19 scoring on the CPU: the rasterizer copy, the
pose errors (MSSD / MSPD / VSD), the matching and recalls, `score_csv`
and the `score-bop` command, against the JAX package on the same
numpy-seeded inputs.

Tolerances and why:
  * render_label: bit-equal ids and depth (the same C++ expressions
    built with the same flags).
  * get_symmetry_transformations, match_poses, bop19_average_recalls:
    exact (the same numpy code).
  * mssd_batch / mspd_batch: 1e-5 relative (float32 transforms; JAX
    einsums at HIGHEST precision against the port's multiply-adds).
  * _vsd_costs: 1e-6 absolute (step costs are pixel counts, exact in
    both; tlinear sums fractions in another order).
  * score_csv: every AR equal (the same matching on errors that agree
    to float32 rounding, away from the thresholds on these poses).
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.eval import bop_score as jbs
from zebrapose_tpu.native import render_label as j_render
from zebrapose_tpu.ops import bop_errors as jbe
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.data import png
from zebrapose_tpu_torch.data.bop_io import save_ply
from zebrapose_tpu_torch.eval import bop_score as tbs
from zebrapose_tpu_torch.native import render_label
from zebrapose_tpu_torch.ops import bop_errors as tbe

K = np.array([[140.0, 0, 64.0], [0, 140.0, 48.0], [0, 0, 1.0]])
W, H = 128, 96
SYMS = {
    "none": {"diameter": 80.0},
    "discrete": {"diameter": 80.0, "symmetries_discrete": [
        list(np.diag([-1.0, -1.0, 1.0, 1.0]).reshape(-1))]},
    "continuous": {"diameter": 80.0, "symmetries_continuous": [
        {"axis": [0, 0, 1], "offset": [0, 0, 5.0]}]},
    "both": {"diameter": 80.0, "symmetries_continuous": [
        {"axis": [0, 1, 0], "offset": [0, 0, 0]}],
        "symmetries_discrete": [
            list(np.diag([1.0, -1.0, -1.0, 1.0]).reshape(-1))]},
}


def _rot(rng):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(rng.normal(size=3)).as_matrix()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_render_label_is_bit_equal_to_jax():
    pts, faces = chip_smoke.uv_sphere(20, 24, radius=40.0)
    classes = np.arange(1, len(faces) + 1, dtype=np.int32)
    rng = np.random.default_rng(0)
    # far, near and partly behind the camera (z from -20 to 60 mm)
    for t in ([0.0, 0.0, 500.0], [30.0, -20.0, 250.0], [5.0, 0.0, 20.0]):
        R = _rot(rng)
        got = render_label(pts, faces, classes, K, R, np.array(t), W, H,
                           with_depth=True)
        want = j_render(pts, faces, classes, K, R, np.array(t), W, H,
                        with_depth=True)
        assert (got[0] > 0).any()
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].tobytes() == want[1].tobytes()
    ids, depth = render_label(pts, faces, classes, K, R, np.array(t), W, H)
    assert depth is None and ids.dtype == np.int32
    with pytest.raises(ValueError, match="faces"):
        render_label(pts, faces + len(pts), classes, K, R, np.array(t), W, H)


@pytest.mark.parametrize("kind", sorted(SYMS))
def test_symmetry_transformations_are_exact(kind):
    got = tbe.get_symmetry_transformations(SYMS[kind], 0.05)
    want = jbe.get_symmetry_transformations(SYMS[kind], 0.05)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", sorted(SYMS))
def test_mssd_mspd_match_jax(kind):
    rng = np.random.default_rng(len(kind))
    n = 12
    pts = rng.uniform(-40, 40, (300, 3)).astype(np.float32)
    R_est = np.stack([_rot(rng) for _ in range(n)]).astype(np.float32)
    R_gt = np.stack([_rot(rng) for _ in range(n)]).astype(np.float32)
    t_est = rng.normal([0, 0, 500], 30, (n, 3)).astype(np.float32)
    t_gt = (t_est + rng.normal(0, 8, (n, 3))).astype(np.float32)
    Ks = np.tile(K[None].astype(np.float32), (n, 1, 1))
    sym_R, sym_t = tbe.get_symmetry_transformations(SYMS[kind], 0.1)
    want_s = np.asarray(jbe.mssd_batch(R_est, t_est, R_gt, t_gt, pts,
                                       sym_R, sym_t))
    want_p = np.asarray(jbe.mspd_batch(R_est, t_est, R_gt, t_gt, Ks, pts,
                                       sym_R, sym_t))
    got_s = tbe.mssd_batch(*map(_t, (R_est, t_est, R_gt, t_gt, pts, sym_R,
                                     sym_t)))
    got_p = tbe.mspd_batch(*map(_t, (R_est, t_est, R_gt, t_gt, Ks, pts,
                                     sym_R, sym_t)))
    assert got_s.dtype == got_p.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5)


def test_mssd_propagates_nan_as_jax():
    """A NaN pose gives NaN, not the other symmetries' minimum (which
    torch.fmin would return)."""
    pts = np.random.default_rng(1).uniform(-40, 40, (50, 3))
    sym_R, sym_t = tbe.get_symmetry_transformations(SYMS["discrete"])
    R = np.tile(np.eye(3), (2, 1, 1))
    t = np.array([[0, 0, 500.0], [np.nan, 0, 500.0]])
    got = tbe.mssd_batch(*map(_t, (R, t, R, t + 1, pts, sym_R, sym_t)))
    want = np.asarray(jbe.mssd_batch(*(np.asarray(a, np.float32) for a in (
        R, t, R, t + 1, pts, sym_R, sym_t))))
    assert np.isnan(want[1]) and np.isnan(got[1].item())
    np.testing.assert_allclose(got[0].item(), want[0], rtol=1e-6)


@pytest.mark.parametrize("cost_type", ["step", "tlinear"])
def test_vsd_costs_match_jax(cost_type):
    rng = np.random.default_rng(3)
    n = 5
    taus = np.arange(0.05, 0.51, 0.05).astype(np.float32)

    def depth(p_zero):
        d = rng.uniform(450, 560, (n, H, W)).astype(np.float32)
        return np.where(rng.random((n, H, W)) < p_zero, 0, d).astype(
            np.float32)

    d_test, d_gt, d_est = depth(0.2), depth(0.4), depth(0.4)
    d_gt[-1] = d_est[-1] = 0            # nothing rendered: empty union
    Ks = np.tile(K[None].astype(np.float32), (n, 1, 1))
    norm = np.full((n,), 80.0, np.float32)
    args = (d_test, d_gt, d_est, Ks, taus)
    want = np.asarray(jbe._vsd_costs(*args, 15.0, norm,
                                     cost_type=cost_type))
    got = tbe._vsd_costs(*map(_t, args), 15.0, _t(norm),
                         cost_type=cost_type).numpy()
    assert want[-1].tolist() == got[-1].tolist() == [1.0] * len(taus)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0.0 < got[:-1].min() and got[:-1].max() < 1.0


def test_match_poses_and_recalls_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(200):
        n_e, n_g = rng.integers(0, 4, 2)
        errs = rng.choice([1.0, 3.0, 6.0, 9.0], (n_e, n_g))
        scores = rng.choice([0.2, 0.5, 0.9], n_e)      # ties included
        for th in (2.0, 5.0, 10.0):
            assert tbs.match_poses(errs, scores, th) == \
                jbs.match_poses(errs, scores, th)
    assert tbs.match_poses(np.array([[1.0], [0.5]]), [0.5, 0.5], 5.0) == 1
    ev = rng.uniform(0, 0.6, (30, 10))
    em, ep = rng.uniform(0, 50, 30), rng.uniform(0, 60, 30)
    em[3] = ep[4] = np.inf
    for vsd in (ev, None):
        assert tbe.bop19_average_recalls(vsd, em, ep, 80.0, 640) == \
            jbe.bop19_average_recalls(vsd, em, ep, 80.0, 640)


@pytest.fixture(scope="module")
def bop_tree(tmp_path_factory):
    """tests/test_bop_score.py's tree, written with the port's tools: 1
    scene x 3 images x 2 objects, GT-rendered depth in 0.1 mm units;
    object 1 with a 180-degree z symmetry. Returns (root, poses)."""
    root = tmp_path_factory.mktemp("bop")
    ds = root / "lmo"
    pts, faces = chip_smoke.uv_sphere(12, 18, radius=40.0)
    (ds / "models").mkdir(parents=True)
    info = {"1": dict(SYMS["discrete"]), "2": {"diameter": 80.0}}
    for oid in (1, 2):
        save_ply(str(ds / "models" / f"obj_{oid:06d}.ply"), pts, faces=faces)
    (ds / "models" / "models_info.json").write_text(json.dumps(info))
    (ds / "camera.json").write_text(json.dumps(
        {"cx": 64.0, "cy": 48.0, "fx": 140.0, "fy": 140.0,
         "width": W, "height": H, "depth_scale": 0.1}))
    scene = ds / "test" / "000001"
    (scene / "depth").mkdir(parents=True)
    rng = np.random.default_rng(9)
    cam, gt, gti, poses = {}, {}, {}, {}
    labels = np.ones(len(faces), np.int32)
    for im in range(3):
        gt[str(im)], gti[str(im)] = [], []
        depth = np.zeros((H, W), np.float32)
        for oid, tx in ((1, -40.0), (2, 40.0)):
            R = _rot(rng)
            t = np.array([tx, 0.0, 500.0]) + rng.normal(0, 5, 3)
            poses[(im, oid)] = (R, t)
            _, d = render_label(pts, faces, labels, K, R, t, W, H,
                                with_depth=True)
            depth = np.where((depth == 0) | ((d > 0) & (d < depth)), d,
                             depth)
            gt[str(im)].append({"cam_R_m2c": list(R.reshape(-1)),
                                "cam_t_m2c": list(t), "obj_id": oid})
            gti[str(im)].append({"visib_fract": 0.9,
                                 "bbox_visib": [0, 0, 10, 10]})
        png.imwrite(str(scene / "depth" / f"{im:06d}.png"),
                    (depth / 0.1).astype(np.uint16))
        cam[str(im)] = {"cam_K": list(K.reshape(-1)), "depth_scale": 0.1}
    for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                      ("scene_gt_info", gti)):
        (scene / f"{name}.json").write_text(json.dumps(obj))
    return root, poses


def _write_csv(path, rows):
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for s, im, o, sc, R, t in rows:
            f.write(f"{s},{im},{o},{sc},"
                    f"{' '.join(str(v) for v in np.reshape(R, -1))},"
                    f"{' '.join(str(v) for v in np.reshape(t, -1))},-1\n")


def _rows(poses, rng):
    """Estimates of mixed quality: exact (one through the symmetry),
    a few mm or degrees off, far off, duplicates and a missing one."""
    S = np.diag([-1.0, -1.0, 1.0])
    rows = []
    for im in range(3):
        R, t = poses[(im, 1)]
        rows.append((1, im, 1, 0.9, R @ S if im == 0 else R,
                     t + rng.normal(0, 2 * im, 3)))
        rows.append((1, im, 1, 0.4, _rot(rng) @ R, t))
    R, t = poses[(0, 2)]
    rows.append((1, 0, 2, 0.9, R, t))
    rows.append((1, 0, 2, 0.1, R, t + np.array([500.0, 0, 0])))
    R, t = poses[(1, 2)]
    rows.append((1, 1, 2, 0.8, R, t + np.array([12.0, 0, 0])))
    return rows


@pytest.mark.parametrize("case", ["vsd", "no_vsd", "targets", "partial"])
def test_score_csv_matches_jax(tmp_path, bop_tree, case):
    root, poses = bop_tree
    csv = str(tmp_path / "sub.csv")
    _write_csv(csv, _rows(poses, np.random.default_rng(5)))
    ds = root / "lmo"
    kw = {"with_vsd": False} if case == "no_vsd" else {}
    targets = ds / "test_targets_bop19.json"
    gone = ds / "test" / "000001" / "depth" / "000001.png"
    hidden = gone.with_suffix(".hidden")
    if case == "targets":     # inst_count 1 keeps only the top estimate
        targets.write_text(json.dumps(
            [{"scene_id": 1, "im_id": im, "obj_id": oid, "inst_count": 1}
             for im in range(3) for oid in (1, 2) if (im, oid) != (2, 1)]))
    if case == "partial":
        gone.rename(hidden)
    try:
        if case == "partial":
            with pytest.warns(UserWarning, match="VSD disabled"):
                want = jbs.score_csv(csv, str(root), "lmo", **kw)
            with pytest.warns(UserWarning, match="VSD disabled"):
                got = tbs.score_csv(csv, str(root), "lmo", device="cpu",
                                    **kw)
        else:
            want = jbs.score_csv(csv, str(root), "lmo", **kw)
            timing, errs = {}, {}
            got = tbs.score_csv(csv, str(root), "lmo", device="cpu",
                                timing=timing, pair_errors=errs, **kw)
            assert set(timing) == {"score_s", "errors_s", "render_s",
                                   "vsd_s", "match_s"}
            assert timing["score_s"] >= (timing["errors_s"]
                                         + timing["match_s"])
            assert sorted(errs) == [1, 2]
            n1 = 2 if case == "targets" else 6
            assert errs[1]["mssd"].shape == (n1,)
            if case == "vsd":
                assert errs[1]["vsd"].shape == (n1, 10)
                assert (errs[1]["vsd_union"] > 0).all()
    finally:
        if case == "targets":
            targets.unlink()
        if case == "partial":
            hidden.rename(gone)
    assert got == want
    assert ("AR_vsd" in got) == (case in ("vsd", "targets"))
    assert 0.0 < got["AR"] < 1.0


def test_score_bop_command(tmp_path, bop_tree, capsys, monkeypatch):
    root, poses = bop_tree
    csv = str(tmp_path / "all.csv")
    _write_csv(csv, [(1, im, oid, 0.9, *poses[(im, oid)])
                     for im in range(3) for oid in (1, 2)])
    args = ["score-bop", "--csv", csv, "--bop_path", str(root), "--dataset",
            "lmo"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["AR"] == pytest.approx(1.0) and out["n_targets"] == 6
    assert {"AR_vsd", "AR_mssd", "AR_mspd"} <= set(out)
    assert cli.main(args + ["--no_vsd", "--device", "cpu"]) == 0
    assert "AR_vsd" not in json.loads(capsys.readouterr().out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbs.score_csv(csv, str(root), "lmo")
