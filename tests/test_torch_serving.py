"""The port's serving export (`eval/export_serving.py`) on the CPU: the
torch.export artifact of one object's eval program against the live
`make_eval_step` and against the JAX package's serving blob, its header
and device guards, the custom op it calls, the dataset drivers
(`serve_dataset`, `run_serve_exported_vivo`, roi_slice) and
`export-serving` then `serve-exported` through `cli.main` against `test`.

Scene: ZebraPoseNet v2 with flax-initialized weights (carried over by
`variables_to_state_dict`; its mask head's bias raised so every crop
pixel is foreground), 96x128 frames with a 150-pixel focal length,
128² crops, 64² code maps, `PnPConfig(n_hypotheses=16,
max_points=512)`. The LUT is made from the JAX network's own codes on
the fixture's frames (`relief_lut`, the scene of
tests/test_torch_slice.py::_scene_lut at this camera), so each crop
decodes to a real pose and the poses compared are converged ones.

Tolerances and why:
  * artifact vs the live port step with the same draws: exact
    (assert_array_equal); the artifact runs the same ops in the same
    order on the same device.
  * artifact vs the JAX blob (JAX's keys given to the port as draws,
    `jax_ransac_draws`): hard masks and codes equal on >= 99.9 % of
    pixels (a logit within 2e-4 of 0 may binarize differently); on the
    rows whose hard outputs agree bit for bit and where both solve, R
    within 1e-4, t within 1e-2 mm, success and n_inliers equal
    (tests/test_torch_slice.py::_assert_poses, the tolerances of
    test_make_eval_step_matches_jax).
  * `serve-exported` vs `test --device cpu` at the same batch and seed:
    byte-equal CSVs (an --f32 blob of the same checkpoint).
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_fleet_serve import fleet_tree  # noqa: F401  (fixture)
from test_torch_model import flax_variables
from test_torch_pnp import jax_ransac_draws
from test_torch_slice import _assert_poses
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.eval import export_serving as jes
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu.ops.binarize import code_from_logits as j_code
from zebrapose_tpu.ops.binarize import mask_from_logits as j_mask
from zebrapose_tpu.ops.roi import map_pixels_to_original as j_map_pixels
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import export_serving as es
from zebrapose_tpu_torch.eval.evaluate import (
    batch_generator,
    make_eval_step,
    run_inference,
)
from zebrapose_tpu_torch.eval.runner import prepare_object_eval
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig, draw_ransac_uniforms
from zebrapose_tpu_torch.ops.roi import final_bbox, square_bbox

H, W = 96, 128
BITS = 16
PNP = dict(n_hypotheses=16, max_points=512)
KW = dict(crop_img=128, crop_gt=64, base=2, n_bits=BITS,
          resize_method="crop_square_resize", loss_type="BCE")
BBOXES = [(30, 20, 50, 40), (-10, 40, 60, 70), (90, 50, 50, 60)]
K = np.array([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]], np.float32)


def _rotation(rng):
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    return R * np.sign(np.linalg.det(R))


def relief_lut(ids, fbs, rng):
    """LUT [2^BITS] making the FIRST pixel of each class id (per row of
    `ids` [B, 64*64]) a noise-free view, through the row's final bbox
    and K, of a relief surface under a per-row pose; later pixels
    sharing an id are outliers."""
    pts = np.zeros((2 ** BITS, 3), np.float32)
    valid = np.zeros((2 ** BITS,), bool)
    Kinv = np.linalg.inv(K.astype(np.float64))
    pix = np.arange(64 * 64)
    px = np.stack([pix % 64, pix // 64], -1).astype(np.int32)
    for b in range(ids.shape[0]):
        R0, t0 = _rotation(rng), np.array([0.0, 0.0, 600.0])
        orig = np.asarray(j_map_pixels(jnp.asarray(px),
                                       jnp.asarray(fbs[b]), 64))
        for p, cid in enumerate(ids[b]):
            if valid[cid]:
                continue
            ox, oy = orig[p]
            d = 600.0 + 40 * np.sin(0.3 * ox) * np.cos(0.25 * oy)
            pts[cid] = R0.T @ (Kinv @ np.array([ox * d, oy * d, d]) - t0)
            valid[cid] = True
    return CorrespondenceLUT(pts, valid, 2, BITS)


@pytest.fixture(scope="module", autouse=True)
def _hide_module_stubs_from_fixtures():
    """tests/test_torch_trainer.py::_hide_module_stubs for the module-scoped
    fixtures too: their exports import torch._dynamo, which walks
    sys.modules with `inspect` and trips on the stub `imgaug` modules of
    tests/test_real_reference_module.py (collected in the same worker)."""
    stubs = {k: sys.modules.pop(k) for k in ("imgaug", "imgaug.augmenters")
             if k in sys.modules}
    yield
    sys.modules.update(stubs)


def _feed(batch, rng):
    """`batch` frames of random pixels, with the host bbox math of
    BBOXES (cycled) as the dataset gives it."""
    params, fbs = [], []
    for i in range(batch):
        bb = np.array(BBOXES[i % len(BBOXES)])
        x1, y1, x2, y2, side = square_bbox(bb)
        params.append([x1, y1, x2, y2, max(side, 1)])
        fbs.append(final_bbox(bb, "crop_square_resize", W, H))
    raw = {"rgb": rng.integers(0, 256, (batch, H, W, 3), dtype=np.uint8),
           "roi_param": np.array(params, np.int32),
           "valid": np.ones((batch,), np.float32)}
    return (raw, np.array(fbs, np.int32),
            np.tile(K[None], (batch, 1, 1)).astype(np.float32))


def _draws(batch, seed):
    return draw_ransac_uniforms(torch.Generator().manual_seed(seed), batch,
                                KW["crop_gt"] ** 2, PnPConfig(**PNP))


def _call(prog, raw, fb, Ks, draws):
    return prog(*prog.frame_args(raw, fb, Ks), draws.prio, draws.u)


@pytest.fixture(scope="module")
def single():
    """The v2 net, the scene LUT of its codes on the b2 feed, the
    serving module, its fixed-batch (b2) blob loaded, and the live step."""
    rng = np.random.default_rng(40)
    variables = flax_variables("v2", rng)
    head = variables["params"]["aspp"]["conv_1x1_4"]["conv"]
    head["bias"] = head["bias"].copy()
    head["bias"][0] = 20.0
    raw, fb, Ks = _feed(2, rng)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JNet(binary_code_length=BITS, variant="v2")
    jimage = j_preprocess(jraw, jax.random.PRNGKey(0), crop_img=128,
                          crop_gt=64, is_train=False,
                          include_gt=False)["image"]
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jimage)
    ids = (np.asarray(j_code(jout["code"])).reshape(2, -1, BITS)
           @ (2 ** np.arange(BITS - 1, -1, -1))).astype(np.int64)
    lut = relief_lut(ids, fb, rng)
    model = ZebraPoseNet(binary_code_length=BITS, variant="v2").eval()
    model.load_state_dict(variables_to_state_dict(variables, "v2"))
    module = es.build_serving_fn(model, lut, pnp_cfg=PnPConfig(**PNP),
                                 device="cpu", **KW)
    blob = es.export_serving(module, 2, (H, W), meta={"obj_name": "ape"})
    live = make_eval_step(lambda b: model(b["image"]), lut,
                          pnp_cfg=PnPConfig(**PNP), preprocess_gt=False,
                          device="cpu", **KW)
    return {"variables": variables, "jmodel": jmodel, "jout": jout,
            "lut": lut, "model": model, "module": module, "blob": blob,
            "prog": es.load_serving(blob, "cpu"), "live": live,
            "feed": (raw, fb, Ks)}


def test_export_roundtrip_bit_exact(single, tmp_path):
    blob = single["blob"]
    assert blob[:len(es.MAGIC)] == es.MAGIC
    path = tmp_path / "ape.serving"
    path.write_bytes(blob)
    prog = es.load_serving(str(path), "cpu")
    assert prog.batch == 2 and prog.rows == 2 and prog.n_models == 1
    assert prog.image_hw == (H, W) and prog.device == torch.device("cpu")
    assert prog.meta["obj_name"] == "ape" and not prog.meta["poly_batch"]

    raw, fb, Ks = _feed(2, np.random.default_rng(11))
    draws = _draws(2, 5)
    got = _call(prog, raw, fb, Ks, draws)
    want = single["live"](raw, fb, Ks, draws=draws)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_artifact_matches_jax_blob(single):
    """The port's artifact against the JAX package's blob of the same
    weights and LUT, with JAX's key stream given to the port as draws."""
    raw, fb, Ks = single["feed"]
    jlut = JLUT(single["lut"].points, single["lut"].valid, 2, BITS)
    serve = jes.build_serving_fn(
        single["jmodel"], single["variables"], jlut,
        pnp_cfg=jpnp.PnPConfig(**PNP), use_kernel=False, **KW)
    jprog = jes.load_serving(jes.export_serving(serve, 2, (H, W)))
    key = jax.random.PRNGKey(11)
    want = jprog(jnp.asarray(raw["rgb"]), jnp.asarray(raw["roi_param"]),
                 jnp.asarray(raw["valid"]), jnp.asarray(fb),
                 jnp.asarray(Ks), key)
    draws = jax_ransac_draws(jax.random.split(key, 2), 64 * 64,
                             PnPConfig(**PNP))
    got = _call(single["prog"], raw, fb, Ks, draws)

    # the hard masks and codes both programs decode
    jout = single["jout"]
    jhard = (np.asarray(j_mask(jout["mask"][..., 0])),
             np.asarray(j_code(jout["code"])))
    live = make_eval_step(lambda b: single["model"](b["image"]),
                          single["lut"], pnp_cfg=PnPConfig(**PNP),
                          preprocess_gt=False, return_masks=True,
                          return_codes=True, device="cpu", **KW)
    out = live(raw, fb, Ks, draws=draws)
    for g, w in zip(got, out[:4]):               # the artifact is the step
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    same = []
    for g, w in zip((out[4], out[6]), jhard):
        g = g.numpy()
        assert np.mean(g == w) >= 0.999
        same.append((g == w).reshape(2, -1).all(-1))
    rows = same[0] & same[1] & got[2].numpy() & np.asarray(want[2])
    assert rows.any()                            # a real pose is compared
    _assert_poses(got, want, rows)


def test_load_rejects_bad_header(tmp_path):
    p = tmp_path / "bad.serving"
    p.write_bytes(b"not a serving artifact")
    with pytest.raises(ValueError, match="bad header"):
        es.load_serving(str(p), "cpu")


def test_cuda_blob_is_refused_without_cuda(single):
    """A blob exported on the card records its device; a host without
    CUDA refuses it instead of running it on the CPU, and a CPU blob is
    not served on another device."""
    blob = single["blob"]
    head, rest = blob[len(es.MAGIC):].split(b"\n", 1)
    meta = json.loads(head)
    meta["device"] = "cuda:0"
    cuda_blob = es.MAGIC + json.dumps(meta).encode() + b"\n" + rest
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            es.load_serving(cuda_blob, "cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            es.load_serving(blob)               # entry points default to CUDA
    with pytest.raises(ValueError, match="exported for cpu"):
        es.load_serving(blob, "meta")


def test_mask_from_dataset_rejected(single):
    with pytest.raises(ValueError, match="serving signature"):
        es.build_serving_fn(single["model"], single["lut"],
                            pnp_cfg=PnPConfig(**PNP),
                            mask_from_dataset=True, device="cpu", **KW)


def test_epnp_custom_op_checks_and_is_one_graph_node(single):
    """torch.library.opcheck of the kernel's op (its CPU and Meta
    implementations) and of the small linear algebra ops, and the op as
    one node of the exported program."""
    from zebrapose_tpu_torch.ops import fast_linalg

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(-40, 40, (64, 6, 3)).astype(np.float32))
    a[..., 2] += 600.0
    b = torch.from_numpy(rng.uniform(0, 128, (64, 6, 2)).astype(np.float32))
    Ks = torch.from_numpy(np.tile(K[None], (64, 1, 1)))
    torch.library.opcheck(torch.ops.zebrapose.epnp_minimal_hypotheses.default,
                          (a, b, Ks, 5))
    A = torch.from_numpy(rng.normal(size=(8, 12, 12)).astype(np.float32))
    A = A @ A.mT + torch.eye(12)
    torch.library.opcheck(fast_linalg.cholesky_small.default, (A,))
    torch.library.opcheck(fast_linalg.cho_solve_small.default,
                          (fast_linalg.cholesky_small(A), A[..., :4]))
    torch.library.opcheck(fast_linalg.polar_rotation.default,
                          (A[:, :3, :3], 12))

    targets = [n.target for n in single["prog"].program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(
        torch.ops.zebrapose.epnp_minimal_hypotheses.default) == 1


def test_poly_batch_export_serves_any_batch(single):
    """batch=None exports a symbolic batch dimension: one blob answers
    any batch size, exactly as the live program."""
    prog = es.load_serving(es.export_serving(single["module"], None,
                                             (H, W)), "cpu")
    assert prog.batch is None and prog.meta["poly_batch"]
    rng = np.random.default_rng(13)
    for batch in (1, 2, 3):
        raw, fb, Ks = _feed(batch, rng)
        draws = _draws(batch, batch)
        got = _call(prog, raw, fb, Ks, draws)
        want = single["live"](raw, fb, Ks, draws=draws)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())

    # the dataset driver picks its own batch for symbolic blobs
    Rs, ts, ok = es.serve_dataset(prog, _StubDataset(), seed=4,
                                  batch_size=2)
    assert Rs.shape == (3, 3, 3) and ok.shape == (3,)


class _StubDataset:
    """collate-compatible stand-in: 3 samples, so batch=2 forces one
    zero-padded tail batch (valid = 0 marks padding), with the GT
    channels the runners' feed extraction reads."""

    def __init__(self):
        rng = np.random.default_rng(3)
        self.raws = [_feed(1, rng) for _ in range(3)]

    def __len__(self):
        return 3

    def collate(self, indices, executor=None):
        parts = [self.raws[i] for i in indices]
        out = {k: np.concatenate([p[0][k] for p in parts])
               for k in ("rgb", "roi_param", "valid")}
        out["final_bbox"] = np.concatenate([p[1] for p in parts])
        out["K"] = np.concatenate([p[2] for p in parts])
        m = len(indices)
        out["label"] = np.zeros((m, H, W, 3), np.uint8)
        out["mask"] = np.zeros((m, H, W), np.uint8)
        out["entire_mask"] = np.zeros((m, H, W), np.uint8)
        return out


def test_serve_dataset_pads_tail(single):
    prog = single["prog"]
    ds = _StubDataset()
    Rs, ts, ok = es.serve_dataset(prog, ds, seed=9)
    assert Rs.shape == (3, 3, 3) and ts.shape == (3, 3)
    assert ok.shape == (3,) and ok.dtype == bool

    # the first full batch equals a direct call with run_inference's
    # draws (batch_generator(seed, batch start))
    raw = ds.collate([0, 1])
    draws = prog.draws(batch_generator(9, 0, "cpu"), 2)
    direct = _call(prog, raw, raw["final_bbox"], raw["K"], draws)
    np.testing.assert_array_equal(Rs[:2], direct[0].numpy())
    np.testing.assert_array_equal(ts[:2], direct[1].numpy())
    # and the run is the live run_inference with the live step
    live = run_inference(ds, single["live"], batch_size=2, seed=9,
                         device="cpu")
    for a, b in zip((Rs, ts, ok), live):
        np.testing.assert_array_equal(a, b)


def _cfg(tree, **extra):
    return ZebraConfig.from_dict(dict(tree["cfg"], **extra))


def test_roi_slice_blob_matches_live_full_frame(single, fleet_tree):  # noqa: F811
    """A blob exported with roi_slice metadata at the walk's buffer dims,
    served through _check_frame_size (which switches the dataset to
    roi_slice), gives the live full-frame program's poses exactly: the
    slice is exact and the blob adds nothing."""
    cfg = _cfg(fleet_tree)
    live = run_inference(prepare_object_eval(cfg, "ape").dataset,
                         single["live"], batch_size=2, seed=3,
                         device="cpu")
    sliced = prepare_object_eval(cfg, "ape").dataset
    hw = sliced.natural_slice_hw()
    assert hw != (H, W)
    prog = es.load_serving(es.export_serving(
        single["module"], 2, hw, meta={"roi_slice": True}), "cpu")
    assert prog.meta["roi_slice"] is True
    es._check_frame_size(prog, sliced)          # switches + imposes hw
    assert sliced.roi_slice and sliced.get_raw(0)["rgb"].shape[:2] == hw
    got = es.serve_dataset(prog, sliced, seed=3)
    for a, b in zip(live, got):
        np.testing.assert_array_equal(a, b)
    # a full-frame split against this blob is refused with the fix named
    with pytest.raises(ValueError, match="--image_h/--image_w"):
        es._check_frame_size(single["prog"], sliced)


def test_serve_exported_vivo(single, fleet_tree, tmp_path):  # noqa: F811
    blob_fn = str(tmp_path / "ape.serving")
    with open(blob_fn, "wb") as f:
        f.write(single["blob"])
    out = str(tmp_path / "out")
    res = es.run_serve_exported_vivo(_cfg(fleet_tree), "ape", blob_fn, out,
                                     seed=3, device="cpu")
    assert res["instances"] == 4 and res["batch"] == 2
    csv = os.path.join(out, "pose_result_bop", "lmo_ape.csv")
    rows = open(csv).read().splitlines()
    # vivo semantics: failed instances dropped, solved carry det scores
    assert len(rows) == 1 + res["solved"]
    for r in rows[1:]:
        assert float(r.split(",")[3]) in (0.9, 0.5, 0.8)


def _write_cfg(tree, path):
    path.write_text("\n".join(f"{k} = {v}" for k, v in tree["cfg"].items())
                    + "\n")
    return str(path)


def test_cli_export_serving_then_serve(fleet_tree, tmp_path, capsys):  # noqa: F811
    """The deployment loop through the CLI: export-serving packages the
    tree's reference .pth (f32, at `test`'s RANSAC settings) into a
    blob; serve-exported answers the split from the blob alone and
    writes the CSV `test --device cpu` writes at the same batch and
    seed, byte for byte."""
    cfg_path = _write_cfg(fleet_tree, tmp_path / "cfg.txt")
    blob = str(tmp_path / "ape.serving")
    common = ["--cfg", cfg_path, "--obj_name", "ape"]
    for flag in (["--platforms", "cuda"], ["--pallas", "on"]):
        with pytest.raises(SystemExit, match="device it was exported on"):
            cli.main(["export-serving", *common, "--ckpt_file",
                      fleet_tree["ckpt"], "--out", blob, "--device", "cpu",
                      *flag])
    capsys.readouterr()
    # --int8 bakes the int8 serving convs in (one int8_conv2d node per
    # quantized conv; tests/test_torch_int8_serving.py serves such blobs)
    assert cli.main(["export-serving", *common, "--ckpt_file",
                     fleet_tree["ckpt"], "--out", blob + ".int8", "--batch",
                     "2", "--image_h", str(H), "--image_w", str(W), "--f32",
                     "--int8", "--device", "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["int8"]
    prog = es.load_serving(blob + ".int8", "cpu")
    assert prog.meta["int8"] and sum(
        n.target is torch.ops.zebrapose.int8_conv2d.default
        for m in prog.program.graph_module.modules()
        if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes) == 37

    assert cli.main(["export-serving", *common, "--ckpt_file",
                     fleet_tree["ckpt"], "--out", blob, "--batch", "2",
                     "--image_h", str(H), "--image_w", str(W), "--f32",
                     "--device", "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["bytes"] > 1_000_000            # the weights are in it
    assert os.path.getsize(blob) == meta["bytes"]

    out_dir = str(tmp_path / "srv_out")
    assert cli.main(["serve-exported", *common, "--blob", blob,
                     "--output_dir", out_dir, "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["instances"] == 3 and res["batch"] == 2
    served = open(os.path.join(out_dir, "pose_result_bop",
                               "lmo_ape.csv"), "rb").read()

    test_dir = str(tmp_path / "test_out")
    assert cli.main(["test", *common, "--ckpt_file", fleet_tree["ckpt"],
                     "--batch_size", "2", "--output_dir", test_dir,
                     "--device", "cpu"]) == 0
    tested, = glob.glob(os.path.join(test_dir, "**", "lmo_ape.csv"),
                        recursive=True)
    assert served == open(tested, "rb").read()
    # header + one row a frame: every frame of the split has a detection
    assert len(served.splitlines()) == 4

    # a CPU blob is not served on the default device without CUDA
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["serve-exported", *common, "--blob", blob])
