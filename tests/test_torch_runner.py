"""Port parity for the `test` runner on the CPU: the host dataset,
`run_inference`, `pose_errors`, `summarize`, `write_csv`, the checkpoint
loader and the `python -m zebrapose_tpu_torch test` command, against
the JAX package on a tiny BOP tree (the recipe of
tests/test_runner_integration.py: 96x128 frames written by cv2, crops
128/64, 16 bits).

Tolerances and why:
  * collate: byte for byte, key by key (integer bookkeeping and PNG
    bytes; the port decodes with its own reader, JAX with cv2).
  * run_inference: R within 1e-4, t within 1e-2 mm, `success` equal, as
    in tests/test_torch_slice.py: JAX's RANSAC draws are injected per
    batch, and an oracle forward turns the GT label crops into logits,
    so the poses rest on exact-geometry scenes (a LUT made from each
    crop's codes), not on a random network's ill-conditioned codes.
  * pose_errors: 1e-4 relative (float32 ADD/ADI, op order only; as
    tests/test_torch_metrics.py). summarize: exact (the same numpy).
  * write_csv: byte for byte on the same poses.
"""

import hashlib
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_slice
from test_torch_pnp import jax_ransac_draws
from torch_oracle import ReferenceNet
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.config import ZebraConfig as JConfig
from zebrapose_tpu.data.bop_writer import write_csv as j_write_csv
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.eval import evaluate as jev
from zebrapose_tpu.eval.runner import prepare_object_eval as j_prepare
from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data.bop_writer import write_csv
from zebrapose_tpu_torch.eval import evaluate as tev
from zebrapose_tpu_torch.eval.runner import (
    load_model,
    load_model_variables,
    prepare_object_eval,
    run_test,
)
from zebrapose_tpu_torch.ops.pnp import PnPConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
K_LIST = [400.0, 0.0, 64.0, 0.0, 400.0, 48.0, 0.0, 0.0, 1.0]
CROP, GT = 128, 64


def _rle(mask):
    """Uncompressed column-major COCO RLE, starting with background."""
    flat = mask.reshape(-1, order="F").astype(np.int64)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    counts = ([0] if flat[0] else []) + runs.tolist()
    return {"counts": counts, "size": [int(mask.shape[0]),
                                       int(mask.shape[1])]}


@pytest.fixture()
def bop_tree(tmp_path):
    """tests/test_runner_integration.py::bop_tree, with RLE masks on the
    detections; returns (bop path, detections path)."""
    from zebrapose_tpu.data.bop_io import save_ply

    ds = tmp_path / "bop" / "lmo"
    rng = np.random.default_rng(140)
    pts = rng.uniform(-30, 30, (60, 3)).astype(np.float32)
    faces = np.array([[i, (i + 1) % 60, (i + 7) % 60] for i in range(40)])
    for d in ("models", "models_eval"):
        (ds / d).mkdir(parents=True)
        save_ply(str(ds / d / "obj_000001.ply"), pts, faces=faces)
        (ds / d / "models_info.json").write_text(
            json.dumps({"1": {"diameter": 75.0}}))
    (ds / "camera.json").write_text(json.dumps(
        {"cx": 64.0, "cy": 48.0, "fx": 400.0, "fy": 400.0,
         "width": W, "height": H, "depth_scale": 1.0}))
    (ds / "models_GT_color").mkdir()
    n_cls = 2 ** 16
    with open(ds / "models_GT_color" / "Class_CorresPoint000001.txt",
              "w") as f:
        f.write(f"{n_cls} 2 16\n")
        for i in range(0, n_cls, 997):
            p = rng.uniform(-30, 30, 3)
            f.write(f"{i} {p[0]} {p[1]} {p[2]}\n")

    scene = ds / "test" / "000002"
    (scene / "rgb").mkdir(parents=True)
    (scene / "mask").mkdir()
    (scene / "mask_visib").mkdir()
    gt_dir = ds / "test_GT_v2" / "000002"
    gt_dir.mkdir(parents=True)
    cam, gt, gti = {}, {}, {}
    for im in range(3):
        cv2.imwrite(str(scene / "rgb" / f"{im:06d}.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        m = np.zeros((H, W), np.uint8)
        m[30:70, 40:90] = 255
        cv2.imwrite(str(scene / "mask" / f"{im:06d}_000000.png"), m)
        cv2.imwrite(str(scene / "mask_visib" / f"{im:06d}_000000.png"), m)
        cv2.imwrite(str(gt_dir / f"{im:06d}_000000.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        cam[str(im)] = {"cam_K": K_LIST, "depth_scale": 1.0}
        gt[str(im)] = [{"cam_R_m2c": list(np.eye(3).reshape(-1)),
                        "cam_t_m2c": [0, 0, 500.0], "obj_id": 1}]
        gti[str(im)] = [{"bbox_visib": [40, 30, 50, 40],
                         "visib_fract": 0.9}]
    (scene / "scene_camera.json").write_text(json.dumps(cam))
    (scene / "scene_gt.json").write_text(json.dumps(gt))
    (scene / "scene_gt_info.json").write_text(json.dumps(gti))

    seg = np.zeros((H, W), np.uint8)
    seg[28:72, 36:92] = 1
    det = {"2/0": [{"obj_id": 1, "bbox_est": [38, 28, 52, 44],
                    "score": 0.9, "segmentation": _rle(seg)}],
           "2/1": [{"obj_id": 1, "bbox_est": [41, 29, 49, 42],
                    "score": 0.8, "segmentation": _rle(seg[::-1])}],
           "2/2": []}  # no detection for image 2 -> dummy sample
    det_path = tmp_path / "det.json"
    det_path.write_text(json.dumps(det))
    return str(tmp_path / "bop"), str(det_path)


def _cfg_dict(bop_path, det_path=None):
    d = {"bop_path": bop_path, "dataset_name": "lmo",
         "test_folder": "test", "BoundingBox_CropSize_image": CROP,
         "BoundingBox_CropSize_GT": GT, "divide_number_each_itration": 2,
         "number_of_itration": 16}
    if det_path:
        d["Detection_reaults"] = det_path
    return d


def _both(bop_tree, mode):
    bop_path, det_path = bop_tree
    d = _cfg_dict(bop_path, det_path if mode in ("detections",
                                                 "mask_rcnn") else None)
    kw = {"roi_slice": mode == "roi_slice", "mask_rcnn": mode == "mask_rcnn"}
    return (j_prepare(JConfig.from_dict(d), "ape", **kw),
            prepare_object_eval(ZebraConfig.from_dict(d), "ape", **kw))


@pytest.mark.parametrize("mode", ["plain", "roi_slice", "detections",
                                  "mask_rcnn"])
def test_collate_is_byte_equal_to_jax(bop_tree, mode):
    je, te = _both(bop_tree, mode)
    assert len(te.dataset) == len(je.dataset) == 3
    assert (te.obj_id, te.diameter, te.symmetric, te.scores) == \
        (je.obj_id, je.diameter, je.symmetric, je.scores)
    np.testing.assert_array_equal(te.vertices, je.vertices)
    np.testing.assert_array_equal(te.lut.points, je.lut.points)
    np.testing.assert_array_equal(te.lut.valid, je.lut.valid)
    want = je.dataset.collate([0, 1, 2])
    got = te.dataset.collate([0, 1, 2])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    if mode in ("detections", "mask_rcnn"):
        np.testing.assert_array_equal(got["valid"], [1, 1, 0])
    if mode == "mask_rcnn":       # the detector's mask, not the file's
        assert got["mask"][0].sum() == 44 * 56 * 255


def _oracle_scene(je, monkeypatch):
    """A LUT that makes each crop's GT codes an exact-geometry view (see
    test_torch_slice._scene_lut) under the tree's intrinsics, built from
    the JAX crops of the three samples."""
    monkeypatch.setattr(test_torch_slice, "K",
                        np.array(K_LIST, np.float32).reshape(3, 3))
    raw = je.dataset.collate([0, 1, 2])
    batch = j_preprocess({k: jnp.asarray(raw[k]) for k in (
        "rgb", "label", "mask", "entire_mask", "roi_param", "valid")},
        jax.random.PRNGKey(0), crop_img=CROP, crop_gt=GT, is_train=False)
    code = np.asarray(batch["code"]).astype(np.int64)
    ids = (code << np.arange(15, -1, -1)).sum(-1).reshape(3, -1)
    pts, valid, R_gt, _ = test_torch_slice._scene_lut(
        ids, raw["final_bbox"], GT, 2 ** 16, range(3),
        np.random.default_rng(4))
    return pts, valid, R_gt


def test_run_inference_matches_jax(bop_tree, monkeypatch):
    je, te = _both(bop_tree, "plain")
    pts, valid, R_gt = _oracle_scene(je, monkeypatch)
    kw = dict(n_hypotheses=32, max_points=512)
    jstep = jev.make_eval_step(
        lambda b, v: {"mask": (b["mask"][..., None] * 2 - 1) * 10,
                      "code": (b["code"] * 2 - 1) * 10},
        JLUT(pts, valid, 2, 16), crop_img=CROP, crop_gt=GT, base=2,
        n_bits=16, resize_method="crop_square_resize", loss_type="BCE",
        pnp_cfg=JPnP(**kw))
    want = jev.run_inference(je.dataset, jstep, batch_size=2, seed=0,
                             num_workers=0)
    tstep = tev.make_eval_step(
        lambda b: {"mask": (b["mask"][..., None] * 2 - 1) * 10,
                   "code": (b["code"] * 2 - 1) * 10},
        CorrespondenceLUT(pts, valid, 2, 16), crop_img=CROP, crop_gt=GT,
        base=2, n_bits=16, resize_method="crop_square_resize",
        loss_type="BCE", pnp_cfg=PnPConfig(**kw), device="cpu")
    cfg = PnPConfig(**kw)

    def draws_for(start):
        keys = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), start), 2)
        return jax_ransac_draws(keys, GT * GT, cfg)

    got = tev.run_inference(te.dataset, tstep, batch_size=2, seed=0,
                            num_workers=2, device="cpu",
                            draws_for=draws_for)
    assert want[2].all(), want[2]
    ang = np.degrees(np.arccos(np.clip(
        (np.einsum("bij,bij->b", want[0], R_gt) - 1) / 2, -1, 1)))
    assert ang.max() < 0.5, ang                  # real poses are compared
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, err_msg="R")
    np.testing.assert_allclose(got[1], want[1], atol=1e-2, err_msg="t")
    np.testing.assert_array_equal(got[2], want[2])

    # the same dataset with the generator: finite poses, padded tail
    R, t, ok = tev.run_inference(te.dataset, tstep, batch_size=2, seed=0,
                                 device="cpu")
    assert R.shape == (3, 3, 3) and np.isfinite(R).all() and ok.all()


def test_run_inference_raises_a_decode_error_and_stops(bop_tree):
    """A frame that cannot be read fails the run with the reader's error,
    and neither the producer thread nor the decode pool outlives it."""
    import threading

    _, te = _both(bop_tree, "plain")
    te.dataset.rgb_files[2] = te.dataset.rgb_files[2] + ".missing"
    before = threading.active_count()

    def step(feed, fb, K, generator=None):
        n = len(fb)
        return (torch.eye(3).expand(n, 3, 3), torch.zeros(n, 3),
                torch.ones(n, dtype=torch.bool))

    with pytest.raises(FileNotFoundError, match="missing"):
        tev.run_inference(te.dataset, step, batch_size=2, num_workers=2,
                          device="cpu")
    assert threading.active_count() == before


@pytest.mark.parametrize("symmetric", [False, True])
def test_pose_errors_and_summarize_match_jax(bop_tree, symmetric):
    je, te = _both(bop_tree, "plain")
    rng = np.random.default_rng(5)
    Rs = np.stack([np.linalg.qr(np.eye(3) + 0.05 * rng.normal(
        size=(3, 3)))[0] for _ in range(3)]).astype(np.float32)
    Rs *= np.sign(np.linalg.det(Rs))[:, None, None]
    ts = (np.array([0, 0, 500.0]) + rng.normal(0, 3, (3, 3))).astype(
        np.float32)
    ok = np.array([True, False, True])
    want = jev.pose_errors(je.dataset, Rs, ts, ok, je.vertices, symmetric)
    got = tev.pose_errors(te.dataset, Rs, ts, ok, te.vertices, symmetric,
                          device="cpu")
    assert got[1] == want[1] == 10000.0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    prefix = "ADD-S" if symmetric else "ADD"
    assert tev.summarize(want, 75.0, prefix) == \
        jev.summarize(want, 75.0, prefix)


def test_write_csv_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(6)
    Rs = list(rng.normal(size=(4, 3, 3)).astype(np.float32))
    ts = [t.reshape(3, 1) for t in rng.normal(size=(4, 3)).astype(
        np.float32) * 300]
    args = ("lmo_ape", 1, [2, 2, 3, 3], [0, 1, 5, 7], Rs, ts,
            [1.0, 0.5, -1, 0.25])
    a = j_write_csv(str(tmp_path / "jax"), *args)
    b = write_csv(str(tmp_path / "port"), *args)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_reference_pth_loads_strictly(tmp_path):
    torch.manual_seed(0)
    net = ReferenceNet(variant="v2", code_len=16).eval()
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": net.state_dict(),
                "iteration_step": 1234}, path)
    sd = load_model_variables(path, "v2")
    assert sorted(sd) == sorted(net.state_dict())
    model = load_model(ZebraConfig(), path, "v2", device="cpu")
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        got = model(x)
        mask, entire, code = net(x.permute(0, 3, 1, 2))
    for name, want in (("mask", mask), ("entire_mask", entire),
                       ("code", code)):
        np.testing.assert_allclose(got[name].numpy(),
                                   want.permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("form", ["ddp_prefix", "no_aliases"])
def test_reference_pth_variants_load_strictly(tmp_path, form):
    """A train_v5/v6 DDP checkpoint (`module.` on every key) and a
    concat_decoder = False one (no `resnet_layer_*` skip-tap aliases)
    load strictly and give the unmodified checkpoint's forward."""
    torch.manual_seed(0)
    net = ReferenceNet(variant="v2", code_len=16).eval()
    sd = net.state_dict()
    if form == "ddp_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    else:
        sd = {k: v for k, v in sd.items()
              if not k.startswith("net.resnet.resnet_layer_")}
        assert len(sd) < len(net.state_dict())
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": sd}, path)
    assert sorted(load_model_variables(path, "v2")) == \
        sorted(net.state_dict())
    model = load_model(ZebraConfig(), path, "v2", device="cpu")
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        got = model(x)
        mask, entire, code = net(x.permute(0, 3, 1, 2))
    for name, want in (("mask", mask), ("entire_mask", entire),
                       ("code", code)):
        np.testing.assert_allclose(got[name].numpy(),
                                   want.permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_reference_pth_missing_key_is_rejected(tmp_path):
    sd = ReferenceNet(variant="v2", code_len=16).state_dict()
    del sd["net.aspp.conv_1x1_4.weight"]
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": sd}, path)
    with pytest.raises(RuntimeError, match="conv_1x1_4.weight"):
        load_model(ZebraConfig(), path, "v2", device="cpu")


def _cli_setup(bop_tree, tmp_path, **extra):
    bop_path, det_path = bop_tree
    torch.manual_seed(2)
    ckpt = str(tmp_path / "ckpt.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", 16).state_dict()},
               ckpt)
    cfg_path = tmp_path / "cfg.txt"
    d = dict(_cfg_dict(bop_path, det_path), **extra)
    cfg_path.write_text("".join(f"{k} = {v}\n" for k, v in d.items()))
    return str(cfg_path), ckpt


def test_cli_test_runs_end_to_end_on_cpu(bop_tree, tmp_path):
    """`python -m zebrapose_tpu_torch test --device cpu` in a fresh
    interpreter (the way users run it; also keeps torch.profiler's lazy
    imports away from this process's stubbed modules)."""
    cfg, ckpt = _cli_setup(bop_tree, tmp_path)
    out = tmp_path / "out"
    prof = tmp_path / "prof"
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "zebrapose_tpu_torch", "test", "--cfg", cfg,
         "--obj_name", "ape", "--ckpt_file", ckpt, "--batch_size", "2",
         "--output_dir", str(out), "--device", "cpu", "--profile",
         str(prof)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    (run_dir,) = os.listdir(out)
    run_dir = out / run_dir
    for name in ("config.txt", "log.txt", "add_err.txt", "ADD_result.txt",
                 os.path.join("pose_result_bop", "lmo_ape.csv")):
        assert (run_dir / name).exists(), name
    rows = (run_dir / "pose_result_bop" / "lmo_ape.csv").read_text() \
        .splitlines()
    # the detection-less frame (score -1) has no row
    assert rows[0] == "scene_id,im_id,obj_id,score,R,t,time"
    assert [r.split(",")[:4] for r in rows[1:]] == \
        [["2", "0", "1", "0.9"], ["2", "1", "1", "0.8"]]
    metrics = dict(ln.split() for ln in
                   (run_dir / "ADD_result.txt").read_text().splitlines())
    assert set(metrics) == {"ADD_recall_0.1d", "ADD_recall_0.05d",
                            "ADD_recall_0.02d", "ADD_mean_err",
                            "ADD_auc_step", "ADD_auc_posecnn"}
    log = (run_dir / "log.txt").read_text()
    assert "ADD_recall_0.1d" in log
    # where the run's time went, measured in it (no CUDA events on the CPU)
    (timing,) = [json.loads(ln.split(" ", 1)[1]) for ln in log.splitlines()
                 if ln.startswith("timing ")]
    assert set(timing) == {"prepare_s", "load_model_s", "inference_s",
                           "collate_s", "wait_s", "step_s", "fetch_s",
                           "pose_errors_s", "write_s"}
    assert all(v >= 0 for v in timing.values())
    assert timing["collate_s"] > 0 and timing["step_s"] > 0
    assert timing["inference_s"] >= (timing["wait_s"] + timing["step_s"]
                                     + timing["fetch_s"])
    assert "device : cpu" in (run_dir / "config.txt").read_text()
    assert (prof / "trace.json").exists()
    merged = tmp_path / "all.csv"
    assert cli.main(["merge-csv", str(run_dir / "pose_result_bop" /
                                      "lmo_ape.csv"),
                     "--out", str(merged)]) == 0
    assert merged.read_text().splitlines() == rows


def test_cli_test_needs_cuda_unless_cpu_is_asked(bop_tree, tmp_path,
                                                 monkeypatch):
    cfg, ckpt = _cli_setup(bop_tree, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["test", "--cfg", cfg, "--obj_name", "ape", "--ckpt_file",
                  ckpt, "--output_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("what", ["int8", "refine", "debug", "orbax", "v3"])
def test_unported_options_raise(bop_tree, tmp_path, what):
    bop_path, _ = bop_tree
    cfg = ZebraConfig.from_dict(dict(_cfg_dict(bop_path),
                                     refine=what == "refine"))
    ckpt = str(tmp_path / "ckpt.pth")
    torch.save(ReferenceNet("v2", 16).state_dict(), ckpt)
    kw = {"device": "cpu"}
    if what in ("int8", "debug"):
        kw[what] = True
    if what == "orbax":
        ckpt = str(tmp_path)
    if what == "v3":
        kw["variant"] = "v3"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_test(cfg, "ape", ckpt, str(tmp_path / "out"), **kw)


def test_committed_lut_is_the_jax_partition_of_the_sphere(tmp_path):
    """trained/rehearsal3_lut.npz = the JAX package's
    generate_mesh_surface_code on the rehearsal sphere (base 2, 16
    levels, seed 0), made with this toolchain's partitioner."""
    import chip_smoke
    from zebrapose_tpu.data.bop_io import save_ply
    from zebrapose_tpu.tools.generate_gt import generate_mesh_surface_code

    pts, faces = chip_smoke.uv_sphere()
    save_ply(str(tmp_path / "sphere.ply"), pts, faces=faces)
    lut, _ = generate_mesh_surface_code(str(tmp_path / "sphere.ply"), 2, 16,
                                        str(tmp_path / "lut.txt"), seed=0)
    with np.load(chip_smoke.LUT) as z:
        np.testing.assert_array_equal(z["points"], lut.points)
        np.testing.assert_array_equal(z["valid"], lut.valid)
        assert (int(z["base"]), int(z["n_digits"])) == (2, 16)
        assert hashlib.sha256((tmp_path / "lut.txt").read_bytes()) \
            .hexdigest() == str(z["text_sha256"])


def test_chip_smoke_tree_reads_back(tmp_path):
    """chip_smoke.py's phase-7 tree, at 2 frames: the port's dataset
    collates the frames and masks that were written, and the JAX
    package's (cv2) reads the same bytes."""
    import chip_smoke

    cfg_path, frames, masks = chip_smoke.write_tree(str(tmp_path),
                                                    n_frames=2)
    te = prepare_object_eval(ZebraConfig.from_file(cfg_path), "ape")
    je = j_prepare(JConfig.from_file(cfg_path), "ape")
    got, want = te.dataset.collate([0, 1]), je.dataset.collate([0, 1])
    assert got["rgb"].tobytes() == frames.tobytes()
    assert got["mask"].tobytes() == masks.tobytes()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert te.diameter == 80.0 and len(te.vertices) == 70200
