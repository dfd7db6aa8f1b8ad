"""The port's fleet serving (`eval/fleet_serve.py`) and the fleet
commands on the CPU: the fleet eval step against the port's
single-object step per object and against the JAX package's fleet step,
the vmapped forward of two real networks against each alone, the LUT
stack's refusal, `run_test_fleet` (unequal split lengths, refinement,
roi_slice through `natural_slice_hw` / `set_slice_hw`) and
`run_vivo_fleet` against the JAX package's, and `train-fleet`,
`test-fleet` and `vivo-fleet` end to end.

Scenes: each object's network is an oracle whose logits are its
"weights" (one fixed mask and code map a member, vmapped over the stacked
members like real weights), and its LUT back-projects each code's crop
pixel through the object's final bbox onto a relief under the object's
pose. Every instance of an object has the same bbox, so every crop
decodes to an exact-geometry view of that pose. JAX's RANSAC draws are
injected into the port.

Tolerances and why:
  * fleet step vs single steps (port): masks and codes equal; R within
    1e-4, t within 1e-2 mm, success equal (the same decode on the same
    inputs; they agree bit for bit here).
  * vmapped forward of ZebraPoseNet v2 vs each network alone: logits
    within 2e-4 (the float32 forward tolerance of
    tests/test_model_parity.py: vmap runs each convolution as a grouped
    one, another float32 op order); hard masks and codes equal on
    >= 99.9 % of pixels.
  * fleet step and commands vs JAX: success equal, R within 1e-4, t
    within 1e-2 mm (tests/test_torch_runner.py's test_run_inference_
    matches_jax); per-object metrics: recalls equal, AUCs within 1e-6
    and the mean error within 1e-3 mm (float32 errors of ~0.01 mm). The CSVs are compared row by row: scene, image,
    object and score equal, R and t to the pose tolerances. Byte
    equality of the pose text would need bit-equal float32 poses from
    two stacks; the writer itself is byte-equal to JAX's on equal poses
    (tests/test_torch_runner.py::test_write_csv_is_byte_equal_to_jax),
    and the merged CSV is byte-equal to the merge of the port's
    per-object CSVs. With refine = True the poses are held to R 1e-3
    and t 0.1 mm: the refiner's Gauss-Newton steps on the tree's random
    mesh amplify the unrefined poses' float32 differences (~1e-6) to
    ~1e-4 (tests/test_torch_refine.py holds the refiner itself to JAX's
    within 1e-6 on equal inputs).
"""

import contextlib
import io
import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from test_torch_pnp import jax_ransac_draws
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from torch_oracle import ReferenceNet
from zebrapose_tpu.config import ZebraConfig as JConfig
from zebrapose_tpu.eval import fleet_serve as jfs
from zebrapose_tpu.ops.pnp import PnPConfig as JPnP
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    save_correspondence_lut,
)
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import fleet_serve as tfs
from zebrapose_tpu_torch.eval.evaluate import make_eval_step
from zebrapose_tpu_torch.eval.runner import prepare_object_eval
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.ops.roi import final_bbox, padding_bbox

H, W = 96, 128
K = np.array([[500.0, 0, 64.0], [0, 500.0, 48.0], [0, 0, 1]], np.float32)
CROP, GT, BITS = 128, 64, 16
PNP = dict(n_hypotheses=32, max_points=512)
# object: (obj id, bbox x y w h, the frames it is in); duck has no
# detection (vivo-fleet skips it)
OBJS = {"ape": (1, [20, 16, 40, 40], (0, 1, 2)),
        "cat": (6, [70, 40, 40, 40], (0, 1)),
        "duck": (9, [40, 50, 30, 30], (0,))}


@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints with Adam's state are ~0.3 GB each: a test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _rotation(rng):
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return R * np.sign(np.linalg.det(R))


def _oracle(box, rng):
    """An object's oracle "weights" (mask [GT, GT] and code [GT, GT,
    BITS] logits), LUT and pose: the crop's central 32² pixels are
    foreground, each with its own class, whose LUT point lies on a
    relief under the pose where the pixel maps through the final bbox
    of `box` (padded 1.5x, as the dataset pads it)."""
    from zebrapose_tpu_torch.ops.roi import map_pixels_to_original

    fb = final_bbox(padding_bbox(np.asarray(box), 1.5),
                    "crop_square_resize", W, H)
    R, t = _rotation(rng), np.array([0.0, 0.0, 600.0])
    mask = np.full((GT, GT), -10.0, np.float32)
    code = np.full((GT, GT, BITS), -10.0, np.float32)
    pts = np.zeros((2 ** BITS, 3), np.float32)
    valid = np.zeros((2 ** BITS,), bool)
    ys, xs = np.mgrid[16:48, 16:48]
    px = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1)
                          .astype(np.int32))
    orig = map_pixels_to_original(px, torch.from_numpy(fb), GT).numpy()
    Kinv = np.linalg.inv(K.astype(np.float64))
    for i, ((x, y), (ox, oy)) in enumerate(zip(px.numpy(), orig)):
        cid = 1 + i
        d = 600.0 + 20 * np.sin(0.3 * ox) * np.cos(0.25 * oy)
        pts[cid] = R.T @ (Kinv @ np.array([ox * d, oy * d, d]) - t)
        valid[cid] = True
        mask[y, x] = 10.0
        code[y, x] = ((cid >> np.arange(BITS - 1, -1, -1)) & 1) * 20.0 - 10.0
    return {"mask": mask, "code": code}, (pts, valid), (R, t)


@pytest.fixture(scope="module")
def fleet_tree(tmp_path_factory):
    """An LM-O tree of 3 frames 96x128: ape in all three, cat in the
    first two, duck in the first; a training split (GT labels) of the
    same frames; each object's oracle and LUT, detections equal to the
    GT boxes (two a frame for the ape, none for the duck), configs."""
    from zebrapose_tpu_torch.data.bop_io import save_ply

    root = tmp_path_factory.mktemp("fleet")
    ds = root / "lmo"
    rng = np.random.default_rng(150)
    pts = rng.uniform(-30, 30, (60, 3)).astype(np.float32)
    faces = np.array([[i, (i + 1) % 60, (i + 7) % 60] for i in range(40)])
    info = {str(o): {"diameter": 75.0} for o, _, _ in OBJS.values()}
    for d in ("models", "models_eval"):
        (ds / d).mkdir(parents=True)
        for o, _, _ in OBJS.values():
            save_ply(str(ds / d / f"obj_{o:06d}.ply"), pts, faces=faces)
        (ds / d / "models_info.json").write_text(json.dumps(info))
    (ds / "camera.json").write_text(json.dumps(
        {"cx": 64.0, "cy": 48.0, "fx": 500.0, "fy": 500.0, "width": W,
         "height": H, "depth_scale": 1.0}))
    (ds / "models_GT_color").mkdir()
    oracles, poses = {}, {}
    for name, (oid, box, _) in OBJS.items():
        oracles[name], lut, poses[name] = _oracle(box, rng)
        save_correspondence_lut(
            str(ds / "models_GT_color" / f"Class_CorresPoint{oid:06d}.txt"),
            CorrespondenceLUT(*lut, 2, BITS))
    dets = {}
    for folder, scene in (("test", "000002"), ("train_real", "000001")):
        sdir = ds / folder / scene
        for sub in ("rgb", "mask", "mask_visib"):
            (sdir / sub).mkdir(parents=True)
        gt_dir = ds / (folder + "_GT_v2") / scene
        gt_dir.mkdir(parents=True)
        cam, gt, gti = {}, {}, {}
        for im in range(3):
            cv2.imwrite(str(sdir / "rgb" / f"{im:06d}.png"),
                        rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            gt[str(im)], gti[str(im)] = [], []
            dets[f"{int(scene)}/{im}"] = []
            for name, (oid, (x, y, w, h), frames) in OBJS.items():
                if im not in frames:
                    continue
                gi = len(gt[str(im)])
                m = np.zeros((H, W), np.uint8)
                m[y:y + h, x:x + w] = 255
                for sub in ("mask", "mask_visib"):
                    cv2.imwrite(str(sdir / sub / f"{im:06d}_{gi:06d}.png"), m)
                cv2.imwrite(str(gt_dir / f"{im:06d}_{gi:06d}.png"),
                            rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
                R, t = poses[name]
                gt[str(im)].append({"cam_R_m2c": R.reshape(-1).tolist(),
                                    "cam_t_m2c": t.tolist(), "obj_id": oid})
                gti[str(im)].append({"bbox_visib": [x, y, w, h],
                                     "visib_fract": 0.9})
                if name != "duck":
                    dets[f"{int(scene)}/{im}"] += [
                        {"obj_id": oid, "bbox_est": [x, y, w, h],
                         "score": s} for s in
                        ((0.9, 0.5) if name == "ape" and im == 0 else (0.8,))]
            cam[str(im)] = {"cam_K": K.reshape(-1).tolist(),
                            "depth_scale": 1.0}
        for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                          ("scene_gt_info", gti)):
            (sdir / f"{name}.json").write_text(json.dumps(obj))
    det_path = root / "det.json"
    det_path.write_text(json.dumps(dets))
    torch.manual_seed(5)
    ckpt = str(root / "ckpt.pth")
    torch.save({"model_state_dict": ReferenceNet("v2", BITS).state_dict()},
               ckpt)
    cfg = {"bop_path": str(root), "dataset_name": "lmo",
           "test_folder": "test", "BoundingBox_CropSize_image": CROP,
           "BoundingBox_CropSize_GT": GT, "divide_number_each_itration": 2,
           "number_of_itration": BITS, "Detection_reaults": str(det_path)}
    yield {"root": str(root), "cfg": cfg, "oracles": oracles,
           "poses": poses, "ckpt": ckpt}
    shutil.rmtree(root, ignore_errors=True)


def _t_oracle(batch, variables):
    n = batch["image"].shape[0]
    return {"mask": variables["mask"][None, ..., None].expand(
                n, -1, -1, 1),
            "entire_mask": variables["mask"][None, ..., None].expand(
                n, -1, -1, 1),
            "code": variables["code"][None].expand(n, -1, -1, -1)}


def _j_oracle(batch, variables):
    n = batch["image"].shape[0]
    m = jnp.broadcast_to(variables["mask"][None, ..., None],
                         (n,) + variables["mask"].shape + (1,))
    return {"mask": m, "entire_mask": m,
            "code": jnp.broadcast_to(variables["code"][None],
                                     (n,) + variables["code"].shape)}


def _stacked(tree, names, jax_side=False):
    out = {k: np.stack([tree["oracles"][n][k] for n in names])
           for k in ("mask", "code")}
    return ({k: jnp.asarray(v) for k, v in out.items()} if jax_side
            else {k: torch.from_numpy(v) for k, v in out.items()})


def _jax_draws(key, starts_k, batch, cfg):
    """The port's draws for object k of the batch at `start`: JAX's
    decode keys split from fold_in(fold_in(key, start), k)."""
    start, k = starts_k
    keys = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, start), k), batch)
    return jax_ransac_draws(keys, GT * GT, cfg)


def _feed(tree, names, batch):
    """One lockstep batch of the named objects' test datasets, as
    fleet_infer collates it."""
    cfg = ZebraConfig.from_dict(tree["cfg"])
    feeds = [tfs._pad_to(prepare_object_eval(cfg, n).dataset.collate(
        list(range(batch))), batch) for n in names]
    return {k: np.concatenate([f[k] for f in feeds]) for k in feeds[0]}


_STEP_KW = dict(crop_img=CROP, crop_gt=GT, base=2, n_bits=BITS,
                resize_method="crop_square_resize", loss_type="BCE")


@pytest.mark.parametrize("mode", ["plain", "mask_from_dataset",
                                  "return_masks"])
def test_fleet_step_matches_single_steps(fleet_tree, mode):
    names = ("ape", "cat")
    cat = _feed(fleet_tree, names, 2)
    feed = {k: cat[k] for k in tfs.FEED_KEYS}
    fb, Ks = cat["final_bbox"].astype(np.int32), cat["K"]
    cfg = ZebraConfig.from_dict(fleet_tree["cfg"])
    luts = [prepare_object_eval(cfg, n).lut for n in names]
    kw = dict(_STEP_KW, pnp_cfg=PnPConfig(**PNP),
              mask_from_dataset=mode == "mask_from_dataset",
              return_masks=mode != "plain", return_codes=True,
              device="cpu")
    lp, lv = tfs.stack_luts(luts)
    step = tfs.make_fleet_eval_step(_t_oracle, lp, lv, **kw)
    out = step(feed, fb, Ks, _stacked(fleet_tree, names),
               generators=[tfs.fleet_generator(0, 0, k, "cpu")
                           for k in range(2)])
    assert out[0].shape == (2, 2, 3, 3) and len(out) == 4 + (
        2 if mode != "plain" else 0) + 1
    for k, n in enumerate(names):
        single = make_eval_step(
            lambda b: _t_oracle(b, {kk: torch.from_numpy(v) for kk, v in
                                    fleet_tree["oracles"][n].items()}),
            luts[k], preprocess_gt=False, **kw)
        rows = slice(2 * k, 2 * k + 2)
        want = single({kk: v[rows] for kk, v in feed.items()}, fb[rows],
                      Ks[rows], generator=tfs.fleet_generator(0, 0, k, "cpu"))
        for a, b in zip(out[4:], want[4:]):            # masks, codes
            assert torch.equal(a[k], b)
        np.testing.assert_allclose(out[0][k], want[0], atol=1e-4)
        np.testing.assert_allclose(out[1][k], want[1], atol=1e-2)
        assert torch.equal(out[2][k], want[2]) and bool(out[2][k].all())
    # object 0's generator is the single path's
    from zebrapose_tpu_torch.eval.evaluate import batch_generator
    assert torch.equal(tfs.fleet_generator(3, 64, 0, "cpu").get_state(),
                       batch_generator(3, 64, "cpu").get_state())


def test_vmapped_forward_matches_each_network():
    """Two ZebraPoseNet v2 networks with their own weights, stacked: the
    vmapped functional forward against each network alone."""
    sds = [variables_to_state_dict(flax_variables(
        "v2", np.random.default_rng(s))) for s in (20, 21)]
    with torch.device("meta"):
        template = ZebraPoseNet(binary_code_length=BITS).eval()
    keep = [n for n, _ in template.named_parameters()] + \
        [n for n, _ in template.named_buffers()]
    variables = tfs.stack_variables([{n: sd[n] for n in keep}
                                     for sd in sds], "cpu")
    x = torch.from_numpy(np.random.default_rng(22).normal(
        size=(2, 2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        got = torch.func.vmap(tfs.model_forward(template))({"image": x},
                                                           variables)
        for k, sd in enumerate(sds):
            net = ZebraPoseNet(binary_code_length=BITS).eval()
            net.load_state_dict(sd, strict=True)
            want = net(x[k])
            for name, v in want.items():
                np.testing.assert_allclose(got[name][k], v, atol=2e-4,
                                           rtol=0, err_msg=name)
                assert ((got[name][k] > 0) == (v > 0)).float().mean() \
                    >= 0.999


def test_fleet_step_matches_jax(fleet_tree):
    names = ("ape", "cat")
    cat = _feed(fleet_tree, names, 2)
    feed = {k: cat[k] for k in tfs.FEED_KEYS}
    fb, Ks = cat["final_bbox"].astype(np.int32), cat["K"]
    cfg = ZebraConfig.from_dict(fleet_tree["cfg"])
    luts = [prepare_object_eval(cfg, n).lut for n in names]
    lp, lv = tfs.stack_luts(luts)
    key = jax.random.PRNGKey(42)
    want = jfs.make_fleet_eval_step(_j_oracle, lp, lv, pnp_cfg=JPnP(**PNP),
                                    **_STEP_KW)(
        {k: jnp.asarray(v) for k, v in feed.items()}, jnp.asarray(fb),
        jnp.asarray(Ks), key, _stacked(fleet_tree, names, True),
        n_models=2)
    pcfg = PnPConfig(**PNP)
    got = tfs.make_fleet_eval_step(_t_oracle, lp, lv, pnp_cfg=pcfg,
                                   device="cpu", **_STEP_KW)(
        feed, fb, Ks, _stacked(fleet_tree, names),
        draws=[jax_ransac_draws(jax.random.split(
            jax.random.fold_in(key, k), 2), GT * GT, pcfg)
            for k in range(2)])
    assert np.asarray(want[2]).all()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-2)
    for k, n in enumerate(names):      # the objects' own poses
        R, t = fleet_tree["poses"][n]
        np.testing.assert_allclose(got[0][k].numpy(),
                                   np.broadcast_to(R, (2, 3, 3)), atol=1e-3)


def test_stack_luts_refuses_mixed_code_spaces():
    a = CorrespondenceLUT(np.zeros((16, 3), np.float32), np.ones(16, bool),
                          2, 4)
    b = CorrespondenceLUT(np.zeros((32, 3), np.float32), np.ones(32, bool),
                          2, 5)
    with pytest.raises(ValueError, match="code space"):
        tfs.stack_luts([a, b])


@contextlib.contextmanager
def _oracles(monkeypatch, tree, names):
    """Both stacks' fleet commands with the oracle networks (forward and
    stacked "weights") and the port with JAX's draws."""
    real_j, real_t = jfs.make_fleet_eval_step, tfs.make_fleet_eval_step
    infer_j, infer_t = jfs.fleet_infer, tfs.fleet_infer
    pcfg = PnPConfig(**PNP)
    monkeypatch.setattr(jfs, "make_fleet_eval_step",
                        lambda fwd, *a, **kw: real_j(_j_oracle, *a, **kw))
    monkeypatch.setattr(tfs, "make_fleet_eval_step",
                        lambda fwd, *a, **kw: real_t(_t_oracle, *a, **kw))
    monkeypatch.setattr(jfs, "fleet_infer", lambda ds, step, v, *a, **kw:
                        infer_j(ds, step, _stacked(tree, names, True),
                                *a, **kw))

    def port_infer(ds, step, v, batch_size, **kw):
        key = jax.random.PRNGKey(0)
        return infer_t(ds, step, _stacked(tree, names), batch_size,
                       draws_for=lambda start: [
                           _jax_draws(key, (start, k), batch_size, pcfg)
                           for k in range(len(ds))], **kw)

    monkeypatch.setattr(tfs, "fleet_infer", port_infer)
    yield


def _csv_rows(path):
    rows = []
    for ln in open(path).read().splitlines()[1:]:
        f = ln.split(",")
        rows.append((f[:4], np.array(f[4].split(), float),
                     np.array(f[5].split(), float)))
    return rows


def _same_csv(a, b, r_tol=1e-4, t_tol=1e-2):
    ra, rb = _csv_rows(a), _csv_rows(b)
    assert [r[0] for r in ra] == [r[0] for r in rb]
    for (_, Ra, ta), (_, Rb, tb) in zip(ra, rb):
        np.testing.assert_allclose(Ra, Rb, atol=r_tol)
        np.testing.assert_allclose(ta, tb, atol=t_tol)
    return ra


def _same_merge(port_csvs, merged):
    text = "".join(open(p).read().split("\n", 1)[1] for p in port_csvs)
    assert open(merged).read() == \
        "scene_id,im_id,obj_id,score,R,t,time\n" + text


@pytest.mark.parametrize("mode", ["plain", "refine", "roi_slice"])
def test_run_test_fleet_matches_jax(fleet_tree, tmp_path, monkeypatch,
                                    mode):
    """ape (3 frames) and cat (2: a padded lockstep batch at b2):
    per-object metrics and CSVs, the merged CSV."""
    names = ["ape", "cat"]
    d = dict(fleet_tree["cfg"], refine=mode == "refine")
    del d["Detection_reaults"]
    ck = [fleet_tree["ckpt"]] * 2
    kw = dict(batch_size=2, roi_slice=mode == "roi_slice")
    with _oracles(monkeypatch, fleet_tree, names):
        want = jfs.run_test_fleet(JConfig.from_dict(d), names, ck,
                                  str(tmp_path / "jax"),
                                  pnp_cfg=JPnP(**PNP), **kw)
        got = tfs.run_test_fleet(ZebraConfig.from_dict(d), names, ck,
                                 str(tmp_path / "port"),
                                 pnp_cfg=PnPConfig(**PNP), device="cpu",
                                 **kw)
    for n in names:
        w, g = want["per_object"][n], got["per_object"][n]
        assert sorted(g) == sorted(w)
        for k in w:
            tol = {"mean_err": 1e-3, "auc_step": 1e-6,
                   "auc_posecnn": 1e-6}.get(k.split("_", 1)[1], 0.0)
            assert abs(g[k] - w[k]) <= tol, (n, k, g[k], w[k])
        # refinement against the tree's random mesh moves every pose
        # away (in both stacks alike); without it the oracles solve
        assert g["ADD_recall_0.1d"] == (0.0 if mode == "refine" else 1.0)
    # the refiner's 10 Gauss-Newton steps on that contour take the
    # poses' float32 differences (~1e-6) to ~1e-4
    tol = (1e-3, 0.1) if mode == "refine" else (1e-4, 1e-2)
    csvs = []
    for n in names:
        csvs.append(os.path.join(tmp_path, "port", "pose_result_bop",
                                 f"lmo_{n}.csv"))
        rows = _same_csv(csvs[-1], os.path.join(
            tmp_path, "jax", "pose_result_bop", f"lmo_{n}.csv"), *tol)
        assert len(rows) == len(OBJS[n][2])
    assert got["merged_csv"].endswith("lmo_fleet.csv")
    _same_csv(got["merged_csv"], want["merged_csv"], *tol)
    _same_merge(csvs, got["merged_csv"])


def test_slice_buffer_is_shared_and_checked(fleet_tree):
    """natural_slice_hw / set_slice_hw as the JAX dataset's: the fleet
    max is imposed, and a buffer smaller than a dataset needs is
    refused."""
    from zebrapose_tpu.eval.runner import prepare_object_eval as jprep

    d = dict(fleet_tree["cfg"])
    del d["Detection_reaults"]
    both = [(jprep(JConfig.from_dict(d), n, roi_slice=True).dataset,
             prepare_object_eval(ZebraConfig.from_dict(d), n,
                                 roi_slice=True).dataset)
            for n in ("ape", "duck")]
    for j, t in both:
        assert t.natural_slice_hw() == j.natural_slice_hw()
    assert both[0][1].natural_slice_hw() != both[1][1].natural_slice_hw()
    big = tuple(max(t.natural_slice_hw()[i] for _, t in both)
                for i in range(2))
    for j, t in both:
        j.set_slice_hw(big)
        t.set_slice_hw(big)
        a, b = j.collate([0]), t.collate([0])
        assert a["rgb"].shape[1:3] == b["rgb"].shape[1:3] == big
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    small = both[0][1]
    small.set_slice_hw((16, 16))
    with pytest.raises(ValueError, match="smaller than this dataset needs"):
        small.collate([0])


def test_run_vivo_fleet_matches_jax(fleet_tree, tmp_path, monkeypatch):
    """ape (4 instances), cat (2), duck (no detection: skipped with a
    warning, instances 0, as in JAX)."""
    names = ["ape", "cat", "duck"]
    d = dict(fleet_tree["cfg"])
    ck = [fleet_tree["ckpt"]] * 3
    outs = {}
    with _oracles(monkeypatch, fleet_tree, names[:2]):
        for who, fn, cfg_cls, pnp in (
                ("jax", jfs.run_vivo_fleet, JConfig, JPnP),
                ("port", tfs.run_vivo_fleet, ZebraConfig, PnPConfig)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                kw = {"device": "cpu"} if who == "port" else {}
                outs[who] = fn(cfg_cls.from_dict(d), names, ck,
                               str(tmp_path / who), batch_size=2,
                               pnp_cfg=pnp(**PNP), **kw)
            assert "WARNING: duck: no detection" in buf.getvalue()
    assert outs["port"]["per_object"] == outs["jax"]["per_object"]
    assert outs["port"]["per_object"]["duck"]["instances"] == 0
    assert outs["port"]["per_object"]["ape"] == {
        "instances": 4, "solved": 4, "solve_rate": 1.0}
    csvs = []
    for n in names[:2]:
        csvs.append(os.path.join(tmp_path, "port", "pose_result_bop",
                                 f"lmo_{n}.csv"))
        rows = _same_csv(csvs[-1], os.path.join(
            tmp_path, "jax", "pose_result_bop", f"lmo_{n}.csv"))
        assert [r[0][3] for r in rows] == (["0.9", "0.5", "0.8", "0.8"]
                                           if n == "ape" else ["0.8"] * 2)
    _same_csv(outs["port"]["merged_csv"], outs["jax"]["merged_csv"])
    _same_merge(csvs, outs["port"]["merged_csv"])


def _write_cfg(tree, tmp_path, **extra):
    path = tmp_path / "cfg.txt"
    d = dict(tree["cfg"], **extra)
    path.write_text("".join(f"{k} = {v}\n" for k, v in d.items()))
    return str(path)


def test_fleet_commands_on_cpu(fleet_tree, tmp_path, capsys):
    """train-fleet (two members, 2 steps with a pose validation; each
    member's checkpoint then tested by test-fleet), test-fleet and
    vivo-fleet with --device cpu: the run dirs, per-object and merged
    CSVs, the JSON result."""
    train_cfg = _write_cfg(
        fleet_tree, tmp_path, training_data_folder="train_real",
        val_folder="test", BoundingBox_CropSize_image=32,
        BoundingBox_CropSize_GT=16, batch_size=2, num_workers=0)
    assert cli.main(["train-fleet", "--cfg", train_cfg, "--obj_names",
                     "ape", "cat", "--from_scratch", "--max_steps", "2",
                     "--log_freq", "2", "--output_dir",
                     str(tmp_path / "runs"), "--device", "cpu"]) == 0
    assert "ape: best val recall" in capsys.readouterr().out
    ckpts = []
    for n in ("ape", "cat"):
        run = tmp_path / "runs" / "lmo" / n
        rows = [json.loads(ln) for ln in
                (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        tags = {r["tag"] for r in rows}
        assert {"train/loss_total", "val/ADD_recall_0.1d",
                "timing/fit_s"} <= tags
        ckpts.append(str(run / "checkpoints" / "steps" / "step_2.pth"))
        assert os.path.exists(ckpts[-1])
    small = _write_cfg(fleet_tree, tmp_path, BoundingBox_CropSize_image=32,
                       BoundingBox_CropSize_GT=16)
    for command, cfg, extra in (
            ("test-fleet", small, ["--max_samples", "2"]),
            ("vivo-fleet", _write_cfg(fleet_tree, tmp_path), [])):
        out = tmp_path / command
        args = [command, "--cfg", cfg, "--obj_names", "ape", "cat",
                "--ckpt_files"] + (ckpts if command == "test-fleet" else
                                   [fleet_tree["ckpt"]] * 2) + [
            "--batch_size", "2", "--output_dir", str(out), "--device",
            "cpu"] + extra
        assert cli.main(args) == 0
        text = capsys.readouterr().out
        res = json.loads(text[text.rindex("\n{\n") + 1:])
        assert sorted(res["per_object"]) == ["ape", "cat"]
        (run_dir,) = os.listdir(out)
        assert res["merged_csv"] == str(out / run_dir / (
            "lmo_fleet.csv" if command == "test-fleet"
            else "lmo_vivo_fleet.csv"))
        for n in ("ape", "cat"):
            assert (out / run_dir / "pose_result_bop" /
                    f"lmo_{n}.csv").exists()
        log = (out / run_dir / "log.txt").read_text()
        assert any(ln.startswith("timing ") for ln in log.splitlines())
        assert f"command : {command}" in \
            (out / run_dir / "config.txt").read_text()


@pytest.mark.parametrize("command", ["train-fleet", "test-fleet",
                                     "vivo-fleet"])
def test_fleet_commands_need_cuda_unless_cpu_is_asked(
        fleet_tree, tmp_path, monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [command, "--cfg", _write_cfg(fleet_tree, tmp_path),
            "--obj_names", "ape", "cat"]
    if command != "train-fleet":
        args += ["--ckpt_files", fleet_tree["ckpt"], fleet_tree["ckpt"],
                 "--output_dir", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)


@pytest.mark.parametrize("command,flag,item", [
    ("test-fleet", "--debug", "A7")])
def test_fleet_refusals_name_their_roadmap_items(fleet_tree, tmp_path,
                                                 command, flag, item):
    """The fleet flags once refused by their ROADMAP item run now:
    `test-fleet --debug` (A7) writes each object's debug set under
    debug/<obj_name>/ (tests/test_torch_visualize.py holds it against
    JAX's)."""
    out = tmp_path / "out"
    args = [command, "--cfg", _write_cfg(fleet_tree, tmp_path,
                                         BoundingBox_CropSize_image=32,
                                         BoundingBox_CropSize_GT=16),
            "--obj_names", "ape", "cat", "--ckpt_files", fleet_tree["ckpt"],
            fleet_tree["ckpt"], "--output_dir", str(out), "--batch_size",
            "2", "--device", "cpu", flag]
    assert cli.main(args) == 0, item
    (run,) = os.listdir(out)
    for name, n in (("ape", 3), ("cat", 2)):
        files = set(os.listdir(out / run / "debug" / name))
        assert {f"{i:06d}_{k}.png" for i in range(n)
                for k in ("mask", "code_err", "pose_gt")} <= files, item


@pytest.mark.parametrize("command", ["test-fleet", "vivo-fleet"])
def test_fleet_commands_run_in_int8(fleet_tree, tmp_path, capsys, command):
    """`test-fleet --int8` and `vivo-fleet --int8` (refused until the int8
    convs were ported) run the members' int8 forwards in turn on the
    CPU and write their CSVs."""
    out = tmp_path / "out"
    args = [command, "--cfg", _write_cfg(fleet_tree, tmp_path),
            "--obj_names", "ape", "cat", "--ckpt_files", fleet_tree["ckpt"],
            fleet_tree["ckpt"], "--batch_size", "2", "--output_dir",
            str(out), "--device", "cpu", "--int8"]
    if command == "test-fleet":
        args += ["--max_samples", "2"]
    assert cli.main(args) == 0
    text = capsys.readouterr().out
    res = json.loads(text[text.rindex("\n{\n") + 1:])
    assert sorted(res["per_object"]) == ["ape", "cat"]
    (run_dir,) = os.listdir(out)
    for n in ("ape", "cat"):
        assert (out / run_dir / "pose_result_bop" / f"lmo_{n}.csv").exists()
