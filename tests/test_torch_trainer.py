"""The port's training loop on the CPU: the training collate and
`MixedBatchIterator` against the JAX package's (byte for byte), `fit`
(log cadence, keep-3 checkpoints, best selection, pose and loss
validation, an exact resume), `build_train_setup`, the `train` command
in a subprocess, and the options that are not ported.

The tree: LM-O layout, object ape, 96x128 frames written by cv2 with a
train split (`train_real`, GT labels in `train_real_GT_v2`) and a
validation split (`test`); ZebraPoseNet v2 at 32² crops, 16² outputs.
"""

import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.data.pipeline import CropDatasetHost as JDataset
from zebrapose_tpu.data.pipeline import MixedBatchIterator as JMixed
from zebrapose_tpu.parallel import mesh as jmesh
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data import bop_io
from zebrapose_tpu_torch.data.pipeline import (
    CropDatasetHost,
    MixedBatchIterator,
)
from zebrapose_tpu_torch.eval.runner import load_model
from zebrapose_tpu_torch.parallel import mesh
from zebrapose_tpu_torch.train import trainer
from zebrapose_tpu_torch.train.checkpoints import CheckpointManager
from zebrapose_tpu_torch.train.state import create_train_state
from zebrapose_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
K_LIST = [400.0, 0.0, 64.0, 0.0, 400.0, 48.0, 0.0, 0.0, 1.0]
CROP, GT = 32, 16


@pytest.fixture(autouse=True)
def _hide_module_stubs():
    """Under xdist every worker imports
    tests/test_real_reference_module.py, whose stub `imgaug` modules
    answer every attribute, `__file__` included. The first torch
    optimizer imports torch._dynamo, which walks sys.modules with
    `inspect` and trips on them; hide them while a test runs."""
    stubs = {k: sys.modules.pop(k) for k in ("imgaug", "imgaug.augmenters")
             if k in sys.modules}
    yield
    sys.modules.update(stubs)


def _split(ds, folder, rng, n, scene="000001", gt_labels=True):
    sdir = ds / folder / scene
    for sub in ("rgb", "mask", "mask_visib"):
        (sdir / sub).mkdir(parents=True)
    gt_dir = ds / (folder + "_GT_v2") / scene
    gt_dir.mkdir(parents=True)
    cam, gt, gti = {}, {}, {}
    for im in range(n):
        cv2.imwrite(str(sdir / "rgb" / f"{im:06d}.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        m = np.zeros((H, W), np.uint8)
        y, x = rng.integers(10, 40), rng.integers(10, 60)
        m[y:y + 40, x:x + 50] = 255
        cv2.imwrite(str(sdir / "mask" / f"{im:06d}_000000.png"), m)
        cv2.imwrite(str(sdir / "mask_visib" / f"{im:06d}_000000.png"), m)
        if gt_labels:
            cv2.imwrite(str(gt_dir / f"{im:06d}_000000.png"),
                        rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        cam[str(im)] = {"cam_K": K_LIST, "depth_scale": 1.0}
        gt[str(im)] = [{"cam_R_m2c": list(np.eye(3).reshape(-1)),
                        "cam_t_m2c": [0, 0, 500.0], "obj_id": 1}]
        gti[str(im)] = [{"bbox_visib": [int(x), int(y), 50, 40],
                         "visib_fract": 0.9}]
    for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                      ("scene_gt_info", gti)):
        (sdir / f"{name}.json").write_text(json.dumps(obj))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(bop path, config dict) of a tree with train_real (5 frames),
    train_second (4 frames) and test (3 frames)."""
    from zebrapose_tpu.data.bop_io import save_ply

    root = tmp_path_factory.mktemp("bop")
    ds = root / "lmo"
    rng = np.random.default_rng(141)
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
    with open(ds / "models_GT_color" / "Class_CorresPoint000001.txt",
              "w") as f:
        f.write(f"{2 ** 16} 2 16\n")
        for i in range(0, 2 ** 16, 997):
            p = rng.uniform(-30, 30, 3)
            f.write(f"{i} {p[0]} {p[1]} {p[2]}\n")
    _split(ds, "train_real", rng, 5)
    _split(ds, "train_second", rng, 4)
    _split(ds, "test", rng, 3, scene="000002")
    cfg = {"bop_path": str(root), "dataset_name": "lmo",
           "training_data_folder": "train_real", "val_folder": "test",
           "test_folder": "test", "BoundingBox_CropSize_image": CROP,
           "BoundingBox_CropSize_GT": GT, "batch_size": 4,
           "num_workers": 0, "total_iteration": 1000,
           "train_obj_visible_theshold": 0.2}
    return str(root), cfg


def _datasets(bop_path, folder="train_real", is_train=True, seed=0):
    s = bop_io.get_dataset(bop_path, "lmo", train=is_train,
                           data_folder=folder)
    kw = dict(is_train=is_train, crop_size_img=CROP, crop_size_gt=GT,
              seed=seed)
    args = (s.dataset_dir, folder, *s.for_obj(1))
    return JDataset(*args, **kw), CropDatasetHost(*args, **kw)


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_training_collate_is_byte_equal_to_jax(tree):
    """Jittered bboxes from the same per-sample seeds, and the same
    pixels, over repeated draws."""
    jd, td = _datasets(tree[0], seed=5)
    for idx in ([0, 1, 2, 3], [4, 4, 0, 2]):
        _equal(td.collate(idx), jd.collate(idx))
    assert td.is_train and len(td) == 5


def test_mixed_batch_iterator_is_byte_equal_to_jax(tree):
    """Two splits mixed at 0.5, one reading thread (num_workers=0: with
    a pool the order of the jitter seeds follows the threads, in JAX
    too)."""
    bop = tree[0]
    (j1, t1), (j2, t2) = _datasets(bop), _datasets(bop, "train_second")
    ji = JMixed(j1, j2, batch_size=6, second_dataset_ratio=0.5, seed=3,
                num_workers=0)
    ti = MixedBatchIterator(t1, t2, batch_size=6, second_dataset_ratio=0.5,
                            seed=3, num_workers=0)
    try:
        assert (ti.n1, ti.n2) == (ji.n1, ji.n2) == (3, 3)
        for _ in range(3):
            _equal(next(ti), next(ji))
    finally:
        ji.close()
        ti.close()
    assert not ti._thread.is_alive()
    # a pool of readers: same shapes, closes cleanly
    it = MixedBatchIterator(_datasets(bop)[1], None, batch_size=4,
                            num_workers=3)
    try:
        b = next(it)
        assert b["rgb"].shape == (4, H, W, 3) and it.n2 == 0
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_mixed_batch_iterator_hands_a_read_error_to_the_consumer(tree):
    ds = _datasets(tree[0])[1]
    ds.rgb_files = [f + ".missing" for f in ds.rgb_files]
    it = MixedBatchIterator(ds, None, batch_size=2, num_workers=0)
    try:
        with pytest.raises(FileNotFoundError):
            next(it)
    finally:
        it.close()


class _Repeat:
    """The same collated batch forever (a resume test must not depend on
    the iterator's position)."""

    def __init__(self, batch):
        self.batch = batch

    def __next__(self):
        return self.batch

    def close(self):
        pass


def _resources(tree, out_dir, train_iter=None, val=True, seed=0,
               **kw) -> trainer.TrainResources:
    from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    bop, cfgd = tree
    cfg = ZebraConfig.from_dict(dict(cfgd, predict_entire_mask=True))
    torch.manual_seed(seed)
    model = ZebraPoseNet(binary_code_length=16, variant="v2").train()
    state = create_train_state(model, 1e-3, n_bits=16, log_freq=5)
    ds = _datasets(bop)[1]
    if train_iter is None:
        train_iter = MixedBatchIterator(ds, None, batch_size=4,
                                        num_workers=0)
    val_ds = _datasets(bop, "test", is_train=False)[1] if val else None
    lut = load_correspondence_lut(os.path.join(
        bop, "lmo", "models_GT_color", "Class_CorresPoint000001.txt"))
    return trainer.TrainResources(
        cfg=cfg, model=model, state=state, train_iter=train_iter,
        val_dataset=val_ds, lut=lut,
        vertices=np.asarray(lut.points[lut.valid][::11], np.float32),
        diameter=75.0, symmetric=False, obj_id=1, obj_name="ape",
        ckpt=CheckpointManager(os.path.join(out_dir, "ck")),
        logger=MetricsLogger(os.path.join(out_dir, "logs"),
                             also_stdout=False),
        total_iterations=1000, device=torch.device("cpu"),
        pnp_cfg=trainer.PnPConfig(n_hypotheses=16, max_points=256),
        val_batch_size=2, **kw)


def _rows(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_fit_logs_checkpoints_and_validates_by_pose(tree, tmp_path,
                                                    monkeypatch):
    """log_freq 2 over 7 steps: logs and checkpoints at 2, 4, 6, 7 (keep
    3), pose validation each time in eval mode (no BN statistic moves),
    the best checkpoint where the recall rose."""
    out = str(tmp_path / "run")
    res = _resources(tree, out)
    recalls = iter([0.25, 0.5, 0.5, 0.4])
    seen = []
    real = trainer.evaluate_object

    def spy(*args, **kw):
        bn = res.model.net.resnet.resnet[1]
        before = bn.running_mean.clone()
        r = real(*args, **kw)
        seen.append((res.model.training, torch.equal(before,
                                                     bn.running_mean)))
        r.metrics["ADD_recall_0.1d"] = next(recalls)
        return r

    monkeypatch.setattr(trainer, "evaluate_object", spy)
    timing = {}
    best = trainer.fit(res, log_freq=2, max_steps=7, timing=timing)
    assert best == 0.5 and res.state.best_score == 0.5
    assert res.state.step == 7
    # validation ran with the model in train mode around it and moved
    # no running statistic
    assert seen == [(True, True)] * 4
    assert sorted(os.listdir(os.path.join(out, "ck", "steps"))) == \
        ["step_4.pth", "step_6.pth", "step_7.pth"]
    assert sorted(os.listdir(os.path.join(out, "ck", "best"))) == \
        ["best_score.txt", "step_4.pth"]
    with open(os.path.join(out, "ck", "best", "best_score.txt")) as f:
        assert f.read() == "0.5 step 4\n"
    rows = _rows(out)
    tags = {r["tag"] for r in rows}
    assert {"train/loss_total", "train/grad_norm", "train/bit_err_15",
            "val/ADD_recall_0.1d", "val/ADD_auc_posecnn"} <= tags
    assert [r["step"] for r in rows if r["tag"] == "train/loss_total"] == \
        [2, 4, 6, 7]
    steps = [r for r in rows if r["tag"] == "train/step_loss_total"]
    assert [r["step"] for r in steps] == list(range(1, 8))
    assert np.isfinite([r["value"] for r in steps]).all()
    logged = {r["step"]: r["value"] for r in rows
              if r["tag"] == "train/loss_total"}
    assert all(logged[s["step"]] == s["value"] for s in steps
               if s["step"] in logged)
    assert timing["steps"] == 7 and timing["val_s"] > 0
    assert timing["fit_s"] >= (timing["wait_s"] + timing["step_s"]
                               + timing["log_s"] + timing["val_s"])
    # a rolling checkpoint is a reference .pth that `test` loads strictly
    cfg = ZebraConfig.from_dict(tree[1])
    m = load_model(cfg, os.path.join(out, "ck", "steps", "step_7.pth"),
                   device="cpu")
    for (k, v), w in zip(m.state_dict().items(),
                         res.model.state_dict().values()):
        assert torch.equal(v, w), k
    payload = torch.load(os.path.join(out, "ck", "best", "step_4.pth"),
                         weights_only=True)
    assert payload["iteration_step"] == payload["step"] == 4
    assert payload["best_score"] == 0.5
    # restore_best loads it into another state, strictly
    other = _resources(tree, str(tmp_path / "other"), _Repeat(None),
                       val=False, seed=1).state
    assert res.ckpt.restore_best(other) is other
    assert other.step == 4 and other.best_score == 0.5
    for (k, v), w in zip(other.model.state_dict().items(),
                         payload["model_state_dict"].values()):
        assert torch.equal(v, w), k
    assert torch.equal(other.histogram, payload["histogram"])


def test_fit_loss_validation_logs_losses_and_never_a_best(tree, tmp_path):
    out = str(tmp_path / "run")
    res = _resources(tree, out)
    assert trainer.fit(res, log_freq=3, max_steps=3, val_mode="loss") == 0.0
    tags = {r["tag"] for r in _rows(out)}
    assert {"val/loss_total", "val/loss_mask", "val/hamming"} <= tags
    assert not any(t.startswith("val/ADD") for t in tags)
    assert not os.path.isdir(os.path.join(out, "ck", "best"))
    with pytest.raises(ValueError, match="val_mode"):
        trainer.fit(res, val_mode="nope")


def test_resume_gives_the_state_of_an_uninterrupted_run(tree, tmp_path):
    """10 steps = 5 steps, a restore into a freshly initialized model,
    and 5 more: parameters, BN statistics, Adam's moments, the step and
    the histogram, exactly (the augmentation generator is seeded from
    the step)."""
    batch = _datasets(tree[0])[1].collate([0, 1, 2, 3])
    a = _resources(tree, str(tmp_path / "a"), _Repeat(batch), val=False)
    trainer.fit(a, log_freq=5, max_steps=10, validate=False)

    b = _resources(tree, str(tmp_path / "b"), _Repeat(batch), val=False)
    trainer.fit(b, log_freq=5, max_steps=5, validate=False)
    c = _resources(tree, str(tmp_path / "b"), _Repeat(batch), val=False,
                   seed=1)
    assert not torch.equal(c.model.net.aspp.conv_1x1_4.weight,
                           b.model.net.aspp.conv_1x1_4.weight)
    c.ckpt.restore(c.state, step=5)
    assert c.state.step == 5
    trainer.fit(c, log_freq=5, max_steps=5, validate=False)
    assert c.state.step == a.state.step == 10
    for (k, v), w in zip(a.model.state_dict().items(),
                         c.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.equal(a.state.histogram, c.state.histogram)
    oa, oc = (s.optimizer.state_dict()["state"] for s in (a.state, c.state))
    assert sorted(oa) == sorted(oc)
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], oc[i][k]), (i, k)


def test_build_train_setup_reads_the_tree_and_the_backbone(tree, tmp_path):
    bop, cfgd = tree
    cfg = ZebraConfig.from_dict(dict(cfgd, training_data_folder_2=
                                     "train_second",
                                     second_dataset_ratio=0.5))
    rng = np.random.default_rng(9)
    sd = {"conv1.weight": torch.from_numpy(
        rng.normal(size=(64, 3, 7, 7)).astype(np.float32))}
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{k}"] = torch.rand(64)
    for layer, n, cin, c in (("layer1", 3, 64, 64), ("layer2", 4, 64, 128)):
        for i in range(n):
            pre = f"{layer}.{i}."
            sd[pre + "conv1.weight"] = torch.rand(c, cin if i == 0 else c,
                                                  3, 3)
            sd[pre + "conv2.weight"] = torch.rand(c, c, 3, 3)
            bns = ["bn1", "bn2"]
            if i == 0 and cin != c:
                sd[pre + "downsample.0.weight"] = torch.rand(c, cin, 1, 1)
                bns.append("downsample.1")
            for bn in bns:
                for k in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{pre}{bn}.{k}"] = torch.rand(c)
    pth = str(tmp_path / "resnet34.pth")
    torch.save(sd, pth)
    res = trainer.build_train_setup(cfg, "ape", str(tmp_path / "out"),
                                    pretrained_backbone=pth, device="cpu")
    try:
        assert torch.equal(res.model.net.resnet.resnet[0].weight,
                           sd["conv1.weight"])
        assert res.train_iter.n1 == res.train_iter.n2 == 2
        assert len(res.val_dataset) == 3 and res.val_dataset.is_train is False
        assert res.device.type == "cpu" and res.state.step == 0
        assert res.total_iterations == 1000
        assert float(res.state.histogram[0]) == -1.0
    finally:
        res.train_iter.close()
    with pytest.raises(FileNotFoundError, match="from_scratch"):
        trainer._resolve_pretrained("auto")
    with pytest.raises(ValueError, match="accum_steps"):
        trainer.build_train_setup(cfg, "ape", str(tmp_path / "o2"),
                                  pretrained_backbone=None, accum_steps=3,
                                  device="cpu")
    with pytest.raises(ValueError, match="Adam"):
        trainer.build_train_setup(
            ZebraConfig.from_dict(dict(cfgd, optimizer_type="SGD")), "ape",
            str(tmp_path / "o3"), pretrained_backbone=None, device="cpu")


def test_world_size_helpers_match_jax():
    assert mesh.scale_for_world(2e-4, 380_000, 8) == \
        jmesh.scale_for_world(2e-4, 380_000, 8)
    for args in ((32, 1, 1), (32, 4, 1), (32, 2, 2)):
        assert mesh.validate_batch_partition(*args, n_processes=1) == \
            jmesh.validate_batch_partition(*args, n_processes=1)
    for args in ((32, 3, 1), (32, 0, 1), (30, 2, 4)):
        with pytest.raises(ValueError):
            mesh.validate_batch_partition(*args)


def _write_cfg(tree, path, **extra):
    d = dict(tree[1], **extra)
    path.write_text("".join(f"{k} = {v}\n" for k, v in d.items()))
    return str(path)


def test_cli_train_runs_end_to_end_on_cpu(tree, tmp_path):
    """`python -m zebrapose_tpu_torch train --device cpu --from_scratch
    --max_steps 2` in a fresh interpreter, then a resume for 1 more step;
    its checkpoint loads into `test`'s loader strictly."""
    cfg = _write_cfg(tree, tmp_path / "cfg.txt")
    out = tmp_path / "runs"
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "zebrapose_tpu_torch", "train", "--obj_name",
            "ape", "--device", "cpu", "--from_scratch", "--log_freq", "1",
            "--output_dir", str(out), "--cache_images"]
    res = subprocess.run(base + ["--cfg", cfg, "--max_steps", "2"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "best val recall:" in res.stdout
    run = out / "lmo_ape"
    assert sorted(os.listdir(run / "checkpoints" / "steps")) == \
        ["step_1.pth", "step_2.pth"]
    rows = [json.loads(ln) for ln in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    assert {"train/loss_total", "val/ADD_recall_0.1d", "timing/fit_s",
            "timing/wait_s"} <= tags
    cfg2 = _write_cfg(tree, tmp_path / "cfg2.txt", load_checkpoint=True)
    res = subprocess.run(base + ["--cfg", cfg2, "--max_steps", "1"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert sorted(os.listdir(run / "checkpoints" / "steps")) == \
        ["step_1.pth", "step_2.pth", "step_3.pth"]
    load_model(ZebraConfig.from_file(cfg),
               str(run / "checkpoints" / "steps" / "step_3.pth"),
               device="cpu")


def test_cli_train_needs_cuda_unless_cpu_is_asked(tree, tmp_path,
                                                  monkeypatch):
    cfg = _write_cfg(tree, tmp_path / "cfg.txt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train", "--cfg", cfg, "--obj_name", "ape",
                  "--from_scratch", "--output_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.build_train_setup(ZebraConfig.from_file(cfg), "ape",
                                  str(tmp_path / "o"),
                                  pretrained_backbone=None)


@pytest.mark.parametrize("flags", [["--multihost"],
                                   ["--input_mode", "prefetch"],
                                   ["--input_mode", "device_cache"]])
def test_unported_train_flags_raise(tree, tmp_path, flags, monkeypatch):
    """The flags once refused by their ROADMAP items: --multihost joins
    the torchrun world and, outside one, says so
    (tests/test_torch_multiproc.py runs it under two ranks); the input
    modes train (tests/test_torch_input_modes.py holds them against
    `stream`)."""
    cfg = _write_cfg(tree, tmp_path / "cfg.txt")
    args = ["train", "--cfg", cfg, "--obj_name", "ape", "--device", "cpu",
            "--from_scratch", "--output_dir", str(tmp_path / "o")] + flags
    if flags == ["--multihost"]:
        for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="no torch.distributed world"
                           ".*torchrun"):
            cli.main(args)
        assert not os.path.exists(tmp_path / "o")
        return
    assert cli.main(args + ["--max_steps", "1", "--log_freq", "1",
                            "--val_mode", "loss"]) == 0
    assert os.path.exists(tmp_path / "o" / "lmo_ape" / "checkpoints" /
                          "steps" / "step_1.pth")
    shutil.rmtree(tmp_path / "o")       # 0.35 GB of checkpoint
