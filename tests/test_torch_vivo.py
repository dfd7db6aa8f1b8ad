"""Port parity for the multi-instance (vivo) path on the CPU: the
instance list of `build_vivo_dataset`, `evaluate_vivo` (plain and the
Mask-RCNN variant) and the `vivo` command, against the JAX package on a
tiny GT-less BOP tree (96x160 frames written by cv2, crops 128/64, 16
bits; the recipe of tests/test_vivo.py).

Tolerances and why:
  * the instance list: equal (files, bboxes, scores, RLE masks) and the
    collated bytes equal.
  * evaluate_vivo: `ok` equal, R within 1e-4 and t within 1e-4 of its
    600 mm length (0.06 mm; the refit's float32 normal equations at that
    depth), and the CSV rows equal in scene, image, object and score
    with R and t to the same tolerances: JAX's RANSAC draws are injected per
    batch and an oracle forward turns the GT label crops into logits, so
    the poses rest on exact-geometry instances (a LUT of back-projected
    points under each instance's pose), as in tests/test_torch_runner.py.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pnp import jax_ransac_draws
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.eval import vivo as jvivo
from zebrapose_tpu.eval.evaluate import make_eval_step as j_make_eval_step
from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.eval import vivo as tvivo
from zebrapose_tpu_torch.eval.evaluate import make_eval_step
from zebrapose_tpu_torch.ops.pnp import PnPConfig

H, W = 96, 160
K = np.array([[500.0, 0, 80.0], [0, 500.0, 48.0], [0, 0, 1]], np.float32)
CROP, GT, N_BITS = 128, 64, 16
PNP = dict(n_hypotheses=32, max_points=512)
# two images: two instances in image 0, one in image 1 (y0, y1, x0, x1)
REGIONS = {0: [(30, 70, 10, 55), (25, 65, 90, 140)], 1: [(20, 60, 40, 90)]}


def _rle(mask):
    """Uncompressed column-major COCO RLE, starting with background."""
    flat = mask.reshape(-1, order="F").astype(np.int64)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    return {"counts": ([0] if flat[0] else []) + runs.tolist(),
            "size": [int(mask.shape[0]), int(mask.shape[1])]}


def _pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q, np.array([0.0, 0.0, 600.0])


@pytest.fixture()
def vivo_tree(tmp_path):
    """A GT-less lmo split (scene 2): rgb frames, scene_camera.json, GT
    code labels of exact-geometry instances under their own poses, the
    LUT those labels index, detections (with RLE masks; one below the
    threshold, one of another object). Returns a dict of its parts."""
    ds = tmp_path / "bop" / "lmo"
    scene = ds / "test" / "000002"
    (scene / "rgb").mkdir(parents=True)
    gt_dir = ds / "test_GT_v2" / "000002"
    gt_dir.mkdir(parents=True)
    rng = np.random.default_rng(72)
    Kinv = np.linalg.inv(K.astype(np.float64))
    lut_pts = np.zeros((2 ** N_BITS, 3), np.float32)
    lut_valid = np.zeros((2 ** N_BITS,), bool)
    cid = 1
    poses, dets, cams, labels = [], {}, {}, {}
    for im, regions in REGIONS.items():
        label = np.zeros((H, W, 3), np.uint8)
        dets[f"2/{im}"] = []
        for (y0, y1, x0, x1) in regions:
            R, t = _pose(rng)
            poses.append((R, t))
            seg = np.zeros((H, W), np.uint8)
            for y in range(y0, y1):
                for x in range(x0, x1):
                    d = 600.0 + 6 * np.sin(x * 0.25) * np.cos(y * 0.2)
                    lut_pts[cid] = R.T @ (Kinv @ np.array([x * d, y * d, d])
                                          - t)
                    lut_valid[cid] = True
                    label[y, x] = ((cid >> 16) & 255, (cid >> 8) & 255,
                                   cid & 255)
                    cid += 1
            seg[y0:y1, x0:x1] = 1
            dets[f"2/{im}"].append(
                {"obj_id": 1, "bbox_est": [x0, y0, x1 - x0, y1 - y0],
                 "score": round(0.95 - 0.1 * len(poses), 2),
                 "segmentation": _rle(seg)})
        dets[f"2/{im}"] += [
            {"obj_id": 1, "bbox_est": [0, 0, 10, 10], "score": 0.1},
            {"obj_id": 4, "bbox_est": [5, 5, 40, 40], "score": 0.99}]
        cv2.imwrite(str(scene / "rgb" / f"{im:06d}.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        labels[str(scene / "rgb" / f"{im:06d}.png")] = str(
            gt_dir / f"{im:06d}_000000.png")
        cv2.imwrite(labels[str(scene / "rgb" / f"{im:06d}.png")], label)
        cams[str(im)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    det_path = tmp_path / "det.json"
    det_path.write_text(json.dumps(dets))
    rgb = [str(scene / "rgb" / f"{im:06d}.png") for im in REGIONS]
    return {"ds": str(ds), "bop": str(tmp_path / "bop"), "rgb": rgb,
            "cams": {fn: cams[str(i)] for i, fn in enumerate(rgb)},
            "dets": dets, "det_path": str(det_path), "labels": labels,
            "lut": (lut_pts, lut_valid), "poses": poses}


def _datasets(tree, use_segmentation=False):
    """The JAX and port vivo datasets of the tree, each reading its
    instance's GT code label (the oracle's input)."""
    out = []
    for mod in (jvivo, tvivo):
        ds, scores = mod.build_vivo_dataset(
            tree["ds"], "test", tree["rgb"], tree["cams"], tree["dets"],
            obj_id=1, score_threshold=0.2, crop_size_img=CROP,
            crop_size_gt=GT, use_segmentation=use_segmentation)
        ds._gt_label_path = (lambda idx, ds=ds:
                             tree["labels"][ds.rgb_files[idx]])
        out.append((ds, scores))
    return out


def test_build_vivo_dataset_matches_jax(vivo_tree):
    (jd, js), (td, ts) = _datasets(vivo_tree, use_segmentation=True)
    assert len(td) == len(jd) == 3 and ts == js == [0.85, 0.75, 0.65]
    assert td.rgb_files == jd.rgb_files == [vivo_tree["rgb"][0]] * 2 + [
        vivo_tree["rgb"][1]]
    for a, b in zip(td.detect_bboxes, jd.detect_bboxes):
        np.testing.assert_array_equal(a, b)
    assert td.detect_segmentations == jd.detect_segmentations
    assert td.gts == jd.gts == [None] * 3
    got, want = td.collate([0, 1, 2]), jd.collate([0, 1, 2])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _steps(tree, mask_from_dataset):
    """JAX and port eval steps over the tree's LUT with the oracle
    forward: mask logits from the code crop's occupancy (dead, all
    background, for the Mask-RCNN variant), code logits from the code."""
    pts, valid = tree["lut"]

    def j_fwd(b, v=None):
        occ = (b["code"].sum(-1) > 0).astype(jnp.float32)
        m = (occ * 20.0 - 10.0)[..., None]
        if mask_from_dataset:
            m = jnp.full_like(m, -10.0)
        return {"mask": m, "entire_mask": m, "code": b["code"] * 20.0 - 10.0}

    def t_fwd(b):
        occ = (b["code"].sum(-1) > 0).to(torch.float32)
        m = (occ * 20.0 - 10.0)[..., None]
        if mask_from_dataset:
            m = torch.full_like(m, -10.0)
        return {"mask": m, "entire_mask": m, "code": b["code"] * 20.0 - 10.0}

    kw = dict(crop_img=CROP, crop_gt=GT, base=2, n_bits=N_BITS,
              resize_method="crop_square_resize", loss_type="BCE",
              mask_from_dataset=mask_from_dataset)
    return (j_make_eval_step(j_fwd, JLUT(pts, valid, 2, N_BITS),
                             pnp_cfg=JPnP(**PNP), **kw),
            make_eval_step(t_fwd, CorrespondenceLUT(pts, valid, 2, N_BITS),
                           pnp_cfg=PnPConfig(**PNP), device="cpu", **kw))


def _draws_for(start):
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                               start), 2)
    return jax_ransac_draws(keys, GT * GT, PnPConfig(**PNP))


T_TOL = 1e-4 * 600.0


def _csv_rows(path):
    """[(scene, im, obj, score strings), R [9], t [3]] of a CSV."""
    rows = open(path).read().splitlines()
    assert rows[0] == "scene_id,im_id,obj_id,score,R,t,time"
    return [(r.split(",")[:4], np.array(r.split(",")[4].split(), float),
             np.array(r.split(",")[5].split(), float)) for r in rows[1:]]


@pytest.mark.parametrize("variant", ["plain", "mask_rcnn"])
def test_evaluate_vivo_matches_jax(vivo_tree, tmp_path, variant):
    """Same `ok`, poses and CSV rows as JAX with its draws injected. In
    the Mask-RCNN variant the mask head is dead and the detector's RLE
    must carry the decode."""
    seg = variant == "mask_rcnn"
    (jd, js), (td, ts) = _datasets(vivo_tree, use_segmentation=seg)
    jstep, tstep = _steps(vivo_tree, seg)
    want = jvivo.evaluate_vivo(jd, js, jstep, 1, "lmo", "ape",
                               output_dir=str(tmp_path / "jax"),
                               batch_size=2)
    got = tvivo.evaluate_vivo(td, ts, tstep, 1, "lmo", "ape",
                              output_dir=str(tmp_path / "port"),
                              batch_size=2, device="cpu",
                              draws_for=_draws_for)
    assert want[2].all()
    for (R, t), Rj, tj in zip(vivo_tree["poses"], want[0], want[1]):
        assert np.degrees(np.arccos(np.clip((np.trace(R.T @ Rj) - 1) / 2,
                                            -1, 1))) < 3.0
        assert np.linalg.norm(tj - t) < 15.0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=T_TOL)
    rows = [_csv_rows(str(tmp_path / w / "pose_result_bop" / "lmo_ape.csv"))
            for w in ("port", "jax")]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]] == [
        ["2", "0", "1", "0.85"], ["2", "0", "1", "0.75"],
        ["2", "1", "1", "0.65"]]
    for (_, Ra, ta), (_, Rb, tb) in zip(*rows):
        np.testing.assert_allclose(Ra, Rb, atol=1e-4)
        np.testing.assert_allclose(ta, tb, atol=T_TOL)

    # a failed instance (score -1) has no row
    td.detect_bboxes[1] = np.array([0, 0, 4, 4])
    ok = tvivo.evaluate_vivo(td, ts, tstep, 1, "lmo", "ape",
                             output_dir=str(tmp_path / "fail"),
                             batch_size=2, device="cpu",
                             draws_for=_draws_for)[2]
    assert ok.tolist() == [True, False, True]
    assert [r[0][3] for r in _csv_rows(str(
        tmp_path / "fail" / "pose_result_bop" / "lmo_ape.csv"))] == \
        ["0.85", "0.65"]


def test_vivo_command_on_cpu(vivo_tree, tmp_path, capsys):
    """`vivo --device cpu` writes the timestamped run dir, the CSV of
    the solved instances and the timing line; `--int8` raises."""
    from torch_oracle import ReferenceNet
    from zebrapose_tpu_torch.codec.lut import save_correspondence_lut

    ds = vivo_tree["ds"]
    os.makedirs(os.path.join(ds, "models_GT_color"))
    save_correspondence_lut(
        os.path.join(ds, "models_GT_color", "Class_CorresPoint000001.txt"),
        CorrespondenceLUT(*vivo_tree["lut"], 2, N_BITS))
    torch.manual_seed(3)
    ckpt = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", N_BITS).state_dict()},
               ckpt)
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(
        f"bop_path = {vivo_tree['bop']}\ndataset_name = lmo\n"
        f"test_folder = test\nBoundingBox_CropSize_image = {CROP}\n"
        f"BoundingBox_CropSize_GT = {GT}\ndivide_number_each_itration = 2\n"
        f"number_of_itration = {N_BITS}\n"
        f"Detection_reaults = {vivo_tree['det_path']}\n")
    out = tmp_path / "out"
    args = ["vivo", "--cfg", str(cfg), "--obj_name", "ape", "--ckpt_file",
            ckpt, "--batch_size", "2", "--output_dir", str(out), "--device",
            "cpu"]
    assert cli.main(args) == 0
    text = capsys.readouterr().out
    res = json.loads(text[text.rindex("{\n"):])
    assert res["instances"] == 3 and 0 <= res["solved"] <= 3
    (run_dir,) = os.listdir(out)
    log = (out / run_dir / "log.txt").read_text()
    (timing,) = [json.loads(ln.split(" ", 1)[1]) for ln in log.splitlines()
                 if ln.startswith("timing ")]
    assert {"prepare_s", "load_model_s", "inference_s", "step_s",
            "write_s"} <= set(timing)
    assert "command : vivo" in (out / run_dir / "config.txt").read_text()
    rows = _csv_rows(str(out / run_dir / "pose_result_bop" / "lmo_ape.csv"))
    assert len(rows) == res["solved"]
    assert {r[0][3] for r in rows} <= {"0.85", "0.75", "0.65"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(args + ["--int8"])
