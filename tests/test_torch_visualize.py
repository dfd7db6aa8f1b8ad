"""The port's debug visualization (`utils/visualize.py`), `test --debug`,
`test-fleet --debug`, `prepare_object_eval(frame=)` and the `visualize`
command on the CPU, against cv2 and the JAX package.

Tolerances and why:
  * resize_linear / resize_nearest against cv2.resize, host_crop against
    the JAX package's (which calls cv2): exact, byte for byte, on
    upscales, downscales, exact 2x, 1- and 3-channel images and crops
    reaching outside the image. cv2 rounds INTER_LINEAR on uint8 in
    fixed point (11-bit weights; its vector code rounds the vertical
    pass as ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), + 2 >> 2),
    and the port does the same arithmetic in numpy.
  * draw_contours against cv2.drawContours (thickness 1, contours from
    findContours CHAIN_APPROX_NONE, holes included): exact.
  * the panels, the pose overlay and the per-sample set: the decoded
    pixels of the port's PNGs equal those of the JAX package's (the
    bytes differ: other encoders), on the same inputs.
  * run_test / run_test_fleet with debug: the same file set as JAX's;
    mask and code panels and the GT pose outline pixel-equal (the oracle
    network's bits are the crops' GT bits in both stacks; the GT pose is
    the tree's); the predicted pose outline is drawn from poses within
    1e-4 of JAX's, so only its presence is compared. The port's CSV with
    debug is byte-equal to its CSV without.
  * prepare_object_eval(frame=): the same samples as JAX's, the same
    ValueError for a frame the walk does not hold.
"""

import functools
import os
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_fleet_serve import (  # noqa: F401  (fleet_tree: a fixture)
    PNP,
    _oracles,
    fleet_tree,
)
from test_torch_pnp import jax_ransac_draws
from test_torch_refine import _oracle_step, _sphere
from test_torch_runner import (  # noqa: F401  (bop_tree: a fixture)
    _both,
    _cfg_dict,
    _oracle_scene,
    bop_tree,
)
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from torch_oracle import ReferenceNet
from zebrapose_tpu.config import ZebraConfig as JConfig
from zebrapose_tpu.eval import fleet_serve as jfs
from zebrapose_tpu.eval import runner as jrunner
from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
from zebrapose_tpu.utils import visualize as jvis
from zebrapose_tpu_torch import cli, native
from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    save_correspondence_lut,
)
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import fleet_serve as tfs
from zebrapose_tpu_torch.eval import runner as trunner
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.utils import visualize as tvis

K = np.array([[400.0, 0, 64.0], [0, 400.0, 48.0], [0, 0, 1]])

@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints here are 0.1-0.35 GB each: a test's files go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)



def _shape(i, h, w):
    return [(h, w), (h, w, 3), (h, w, 1)][i % 3]


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_resize_equals_cv2(interp):
    fn, flag = {"linear": (tvis.resize_linear, cv2.INTER_LINEAR),
                "nearest": (tvis.resize_nearest, cv2.INTER_NEAREST)}[interp]
    rng = np.random.default_rng(1)
    cases = [(256, 256, 128), (128, 128, 64), (384, 384, 128),
             (100, 100, 50), (64, 64, 64), (1, 1, 5), (3, 700, 33)]
    cases += [tuple(int(v) for v in rng.integers(1, 300, 3))
              for _ in range(60)]
    for i, (h, w, size) in enumerate(cases):
        img = rng.integers(0, 256, _shape(i, h, w), dtype=np.uint8)
        want = cv2.resize(img, (size, size), interpolation=flag)
        got = fn(img, size)
        assert got.shape == want.shape and got.dtype == np.uint8, (h, w)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, size)))


@pytest.mark.parametrize("nearest", [False, True])
def test_host_crop_equals_jax(nearest):
    rng = np.random.default_rng(2)
    boxes = [(10, 12, 40, 40), (-15, -9, 50, 50), (100, 70, 60, 60),
             (-20, 30, 200, 200), (200, 200, 30, 30), (5, 5, 0, 0),
             (20, 10, 64, 64), (0, 0, 128, 96)]
    boxes += [tuple(int(v) for v in rng.integers(-40, 120, 2))
              + tuple(int(v) for v in rng.integers(1, 150, 2))
              for _ in range(20)]
    for i, fb in enumerate(boxes):
        img = rng.integers(0, 256, [(96, 128), (96, 128, 3)][i % 2],
                           dtype=np.uint8)
        for size in (64, 32, 128):
            want = jvis.host_crop(img, np.array(fb), size, nearest=nearest)
            got = tvis.host_crop(img, np.array(fb), size, nearest=nearest)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(fb))


def _masks(rng, n=24, h=48, w=64):
    """Random blobs with holes, thin strokes and single pixels."""
    out = []
    for i in range(n):
        m = np.zeros((h, w), np.uint8)
        for _ in range(rng.integers(1, 5)):
            y, x = rng.integers(0, h), rng.integers(0, w)
            r = rng.integers(1, 14)
            yy, xx = np.ogrid[:h, :w]
            m[(yy - y) ** 2 + (xx - x) ** 2 <= r * r] = 255
        for _ in range(rng.integers(0, 3)):          # holes
            y, x = rng.integers(0, h), rng.integers(0, w)
            m[max(y - 2, 0):y + 2, max(x - 2, 0):x + 2] = 0
        if i % 4 == 0:
            m[rng.integers(0, h), :] = 255               # a thin stroke
            m[rng.integers(0, h), rng.integers(0, w)] = 255
        if i % 5 == 0:
            m |= (rng.random((h, w)) > 0.85).astype(np.uint8) * 255
        out.append(m)
    return out


def test_draw_contours_equals_cv2():
    rng = np.random.default_rng(3)
    for mask in _masks(rng):
        base = rng.integers(0, 256, mask.shape + (3,), dtype=np.uint8)
        for mode in (cv2.RETR_EXTERNAL, cv2.RETR_LIST):
            contours, _ = cv2.findContours(mask, mode,
                                           cv2.CHAIN_APPROX_NONE)
            want = cv2.drawContours(base.copy(), contours, -1,
                                    (0, 255, 0), 1)
            got = tvis.draw_contours(base.copy(),
                                     [c[:, 0, :] for c in contours],
                                     (0, 255, 0))
            np.testing.assert_array_equal(got, want)
        want = cv2.drawContours(
            base.copy(), cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                          cv2.CHAIN_APPROX_NONE)[0],
            -1, (255, 0, 0), 1)
        got = tvis.draw_contours(base.copy(),
                                 native.find_external_contours(mask),
                                 (255, 0, 0))
        np.testing.assert_array_equal(got, want)


def _pixels(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def _same_png(a, b):
    np.testing.assert_array_equal(_pixels(a), _pixels(b), err_msg=a)


def test_panels_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    pred = (rng.random((32, 40)) > 0.5).astype(np.float32)
    gt = (rng.random((32, 40)) > 0.4).astype(np.float32)
    code = (rng.random((32, 40, 16)) > 0.5).astype(np.float32)
    gcode = (rng.random((32, 40, 16)) > 0.5).astype(np.float32)
    for name, fn, args in (
            ("mask", "save_mask_panel", (pred, gt)),
            ("mask_only", "save_mask_panel", (pred,)),
            ("code", "save_code_grid", (code, gcode)),
            ("code_only", "save_code_grid", (code[..., :7],))):
        a, b = str(tmp_path / f"{name}_j.png"), str(tmp_path / f"{name}.png")
        getattr(jvis, fn)(a, *args)
        getattr(tvis, fn)(b, *args)
        _same_png(a, b)


def _overlay_case(rng):
    v, f = _sphere()
    th = rng.uniform(0, 2 * np.pi)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    t = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 500.0])
    crop = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    fb = np.array([rng.integers(20, 50), rng.integers(10, 40),
                   rng.integers(30, 80), rng.integers(30, 80)])
    return v, f, R, t, crop, fb


def test_pose_overlay_equals_jax(tmp_path):
    rng = np.random.default_rng(5)
    for i in range(4):
        v, f, R, t, crop, fb = _overlay_case(rng)
        a, b = str(tmp_path / f"{i}_j.png"), str(tmp_path / f"{i}.png")
        jvis.save_pose_overlay(a, crop, v, f, K, R, t, fb, 64,
                               color=(255, 0, 0))
        tvis.save_pose_overlay(b, crop, v, f, K, R, t, fb, 64,
                               color=(255, 0, 0))
        _same_png(a, b)
        assert (_pixels(b) != crop).any()


@pytest.mark.parametrize("case", ["full", "failed_pose", "point_cloud",
                                  "no_gt"])
def test_dump_debug_sample_equals_jax(tmp_path, case):
    rng = np.random.default_rng(6)
    v, f, R, t, crop, fb = _overlay_case(rng)
    args = (crop, (rng.random((64, 64)) > 0.5).astype(np.float32),
            (rng.random((64, 64)) > 0.5).astype(np.float32),
            (rng.random((64, 64, 16)) > 0.5).astype(np.float32),
            (rng.random((64, 64, 16)) > 0.5).astype(np.float32), v,
            None if case == "point_cloud" else f, K, R, t, fb)
    kw = dict(R_gt=None if case == "no_gt" else R @ R,
              t_gt=None if case == "no_gt" else t + 3,
              render_pred=case != "failed_pose")
    jvis.dump_debug_sample(str(tmp_path / "jax"), 7, *args, **kw)
    tvis.dump_debug_sample(str(tmp_path / "port"), 7, *args, **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == {"full": 4, "failed_pose": 3, "point_cloud": 2,
                          "no_gt": 3}[case]
    for n in names:
        _same_png(str(tmp_path / "jax" / n), str(tmp_path / "port" / n))


@pytest.mark.parametrize("frame", [(2, 1), (2, 0), (3, 0), (2, 9)])
def test_prepare_object_eval_frame_equals_jax(bop_tree, frame):
    bop_path, det_path = bop_tree
    d = _cfg_dict(bop_path, det_path)
    if frame in ((3, 0), (2, 9)):
        for prep, cfg in ((jrunner.prepare_object_eval, JConfig),
                          (trunner.prepare_object_eval, ZebraConfig)):
            with pytest.raises(ValueError,
                               match=f"frame scene={frame[0]} im="
                                     f"{frame[1]} not found in test "
                                     r"\(object ape\); 3 frames walked"):
                prep(cfg.from_dict(d), "ape", frame=frame)
        return
    je = jrunner.prepare_object_eval(JConfig.from_dict(d), "ape",
                                     frame=frame)
    te = trunner.prepare_object_eval(ZebraConfig.from_dict(d), "ape",
                                     frame=frame)
    assert te.dataset.rgb_files == je.dataset.rgb_files and \
        len(te.dataset) == 1
    assert te.scores == je.scores
    assert te.dataset.detect_bboxes[0].tolist() == \
        je.dataset.detect_bboxes[0].tolist()
    want, got = je.dataset.collate([0]), te.dataset.collate([0])
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _debug_tree(bop_tree, tmp_path, monkeypatch):
    """tests/test_torch_refine.py's refined run_test setup: the oracle
    LUT, a UV sphere for the mesh, a random v2 checkpoint, both stacks'
    steps on the oracle forward and the port on JAX's draws."""
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
    cfg = PnPConfig(n_hypotheses=32, max_points=512)

    def draws_for(start):
        keys = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), start), 2)
        return jax_ransac_draws(keys, 64 * 64, cfg)

    monkeypatch.setattr(jrunner, "make_eval_step",
                        _oracle_step(jrunner.make_eval_step, True))
    monkeypatch.setattr(trunner, "make_eval_step",
                        _oracle_step(trunner.make_eval_step, False))
    from zebrapose_tpu_torch.eval import evaluate as tev
    infer = functools.partial(tev.run_inference, draws_for=draws_for)
    # run_test's debug / refine branch, and evaluate_object's
    monkeypatch.setattr(trunner, "run_inference", infer)
    monkeypatch.setattr(tev, "run_inference", infer)
    return ckpt, cfg


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _same_debug_set(port_dir, jax_dir, n_samples):
    names = _files(jax_dir)
    assert _files(port_dir) == names
    for i in range(n_samples):
        for kind in ("mask", "code_err", "pose_gt"):
            _same_png(os.path.join(port_dir, f"{i:06d}_{kind}.png"),
                      os.path.join(jax_dir, f"{i:06d}_{kind}.png"))
        assert f"{i:06d}_pose.png" in names
    return names


@pytest.mark.parametrize("refine", [False, True])
def test_run_test_debug_matches_jax(bop_tree, tmp_path, monkeypatch,
                                    refine):
    ckpt, cfg = _debug_tree(bop_tree, tmp_path, monkeypatch)
    d = dict(_cfg_dict(bop_tree[0]), refine=refine)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jrunner.run_test(JConfig.from_dict(d), "ape", ckpt, jout,
                            batch_size=2, debug=True,
                            pnp_cfg=JPnP(n_hypotheses=32, max_points=512))
    got = trunner.run_test(ZebraConfig.from_dict(d), "ape", ckpt, tout,
                           batch_size=2, debug=True, pnp_cfg=cfg,
                           device="cpu")
    assert sorted(got) == sorted(want)
    names = _same_debug_set(os.path.join(tout, "debug"),
                            os.path.join(jout, "debug"), 3)
    assert any(n.startswith("refine" + os.sep) for n in names) == refine
    # the same frames without debug: the same CSV, byte for byte
    plain = str(tmp_path / "plain")
    trunner.run_test(ZebraConfig.from_dict(d), "ape", ckpt, plain,
                     batch_size=2, pnp_cfg=cfg, device="cpu")
    csv = os.path.join("pose_result_bop", "lmo_ape.csv")
    with open(os.path.join(tout, csv)) as a, \
            open(os.path.join(plain, csv)) as b:
        assert a.read() == b.read()
    assert not os.path.exists(os.path.join(plain, "debug"))


def test_run_test_fleet_debug_matches_jax(fleet_tree, tmp_path,
                                          monkeypatch):
    """ape (3 frames) and cat (2): debug/<obj>/ of both stacks."""
    names = ["ape", "cat"]
    d = dict(fleet_tree["cfg"])
    del d["Detection_reaults"]
    ck = [fleet_tree["ckpt"]] * 2
    with _oracles(monkeypatch, fleet_tree, names):
        jfs.run_test_fleet(JConfig.from_dict(d), names, ck,
                           str(tmp_path / "jax"), batch_size=2,
                           pnp_cfg=JPnP(**PNP), debug=True)
        tfs.run_test_fleet(ZebraConfig.from_dict(d), names, ck,
                           str(tmp_path / "port"), batch_size=2,
                           pnp_cfg=PnPConfig(**PNP), device="cpu",
                           debug=True)
    assert sorted(os.listdir(tmp_path / "port" / "debug")) == names
    for n, frames in (("ape", 3), ("cat", 2)):
        _same_debug_set(str(tmp_path / "port" / "debug" / n),
                        str(tmp_path / "jax" / "debug" / n), frames)


def test_visualize_command_runs_end_to_end(bop_tree, tmp_path, capsys):
    """`visualize` on one frame with --device cpu: the run dir, the
    frame in its config, the artifact set, and the metrics of
    run_test(frame=) at batch 1."""
    import json

    bop_path, _ = bop_tree
    d = _cfg_dict(bop_path)
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text("".join(f"{k} = {v}\n" for k, v in d.items()))
    torch.manual_seed(1)
    ckpt = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", 16).state_dict()},
               ckpt)
    out = tmp_path / "vis"
    assert cli.main(["visualize", "--cfg", str(cfg_path), "--obj_name",
                     "ape", "--ckpt_file", ckpt, "--scene", "2", "--im",
                     "1", "--output_dir", str(out), "--device",
                     "cpu"]) == 0
    text = capsys.readouterr().out
    (run_dir,) = os.listdir(out)
    assert f"debug artifacts: {out / run_dir / 'debug'}" in text
    assert "frame : 2/1" in (out / run_dir / "config.txt").read_text()
    files = sorted(os.listdir(out / run_dir / "debug"))
    assert {"000000_mask.png", "000000_code_err.png",
            "000000_pose_gt.png"} <= set(files)
    start = text.index("\n{\n") + 1
    metrics = json.loads(text[start:text.index("\n}\n", start) + 2])
    want = trunner.run_test(ZebraConfig.from_dict(d), "ape", ckpt,
                            str(tmp_path / "direct"), batch_size=1,
                            frame=(2, 1), device="cpu")
    assert json.dumps(metrics) == json.dumps(want)       # NaN AUCs too
    # the mask panel is the network's mask beside the GT crop's
    panel = _pixels(str(out / run_dir / "debug" / "000000_mask.png"))
    assert panel.shape == (64, 192)
