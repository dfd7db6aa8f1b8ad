"""The port's fleet serving export on the CPU: one torch.export artifact
of K = 2 objects' eval program (`build_fleet_serving_fn`: the members'
forwards in turn, K decodes) against the live fleet step and against
the JAX package's fleet blob, its guards, and `export-serving-fleet`,
the fleet drivers (`serve_fleet_datasets`, `run_serve_exported_fleet`,
`run_serve_exported_vivo_fleet`) and `serve-exported-fleet` through
`cli.main`.

Scene and tolerances as in tests/test_torch_serving.py: each member is
ZebraPoseNet v2 with its own flax-initialized weights (mask head's bias
raised), its LUT made from its own JAX codes on its rows of the feed, so
each object's crops decode to real poses.
  * the artifact (symbolic batch, served at 1, 2 and 3) against the live
    fleet step with forwards in turn and the same draws: exact.
  * the live step with forwards in turn against the vmapped one that
    `test-fleet` runs: logits within 2e-4 (grouped against single
    convolutions, another float32 op order; the forward tolerance of
    tests/test_torch_fleet_serve.py), hard masks and codes equal on
    >= 99.9 % of pixels, poses to _assert_poses on the rows whose hard
    outputs agree.
  * against the JAX blob, per object (JAX's keys split(fold_in(key, k),
    B) given to the port as draws): hard masks and codes equal on
    >= 99.9 % of pixels; on the rows whose hard outputs agree and where
    both solve, R within 1e-4, t within 1e-2 mm, success and n_inliers
    equal.
  * `serve_fleet_datasets` with the blob of `export-serving-fleet --f32`
    against `fleet_infer` with the live step of the same checkpoints:
    exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_fleet_serve import fleet_tree  # noqa: F401  (fixture)
from test_torch_model import flax_variables
from test_torch_pnp import jax_ransac_draws
from test_torch_serving import (  # noqa: F401  (the fixture: autouse)
    BITS,
    KW,
    PNP,
    H,
    W,
    _feed,
    _hide_module_stubs_from_fixtures,
    _StubDataset,
    relief_lut,
)
from test_torch_slice import _assert_poses
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.eval import export_serving as jes
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu.ops.binarize import code_from_logits as j_code
from zebrapose_tpu.ops.binarize import mask_from_logits as j_mask
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import export_serving as es
from zebrapose_tpu_torch.eval import fleet_serve as tfs
from zebrapose_tpu_torch.eval.runner import prepare_object_eval
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig

NAMES = ["ape", "cat"]


@pytest.fixture(scope="module")
def fleet():
    """Two members' weights and scene LUTs, the fleet serving module,
    its symbolic-batch blob loaded, and the live fleet step (forwards in
    turn, masks and codes returned)."""
    rng = np.random.default_rng(41)
    raw, fb, Ks = _feed(4, rng)                 # rows 0-1: ape, 2-3: cat
    jmodel = JNet(binary_code_length=BITS, variant="v2")
    jimage = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()},
                          jax.random.PRNGKey(0), crop_img=128, crop_gt=64,
                          is_train=False, include_gt=False)["image"]
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    variables, luts, jouts = [], [], []
    for k in range(2):
        v = flax_variables("v2", rng)
        head = v["params"]["aspp"]["conv_1x1_4"]["conv"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] = 20.0
        jout = apply(v, jimage[2 * k:2 * k + 2])
        ids = (np.asarray(j_code(jout["code"])).reshape(2, -1, BITS)
               @ (2 ** np.arange(BITS - 1, -1, -1))).astype(np.int64)
        variables.append(v)
        luts.append(relief_lut(ids, fb[2 * k:2 * k + 2], rng))
        jouts.append(jout)
    with torch.device("meta"):
        template = ZebraPoseNet(binary_code_length=BITS).eval()
    keep = [n for n, _ in template.named_parameters()] + \
        [n for n, _ in template.named_buffers()]
    sds = [variables_to_state_dict(v, "v2") for v in variables]
    stacked = tfs.stack_variables([{n: sd[n] for n in keep} for sd in sds],
                                  "cpu")
    module = es.build_fleet_serving_fn(template, stacked, luts,
                                       pnp_cfg=PnPConfig(**PNP),
                                       device="cpu", **KW)
    blob = es.export_serving(module, None, (H, W),
                             meta={"obj_names": NAMES})
    lp, lv = tfs.stack_luts(luts)

    def live(vmap_forward):
        return tfs.make_fleet_eval_step(
            tfs.model_forward(template), lp, lv, pnp_cfg=PnPConfig(**PNP),
            return_masks=True, return_codes=True, vmap_forward=vmap_forward,
            device="cpu", **KW)

    return {"variables": variables, "jmodel": jmodel, "jouts": jouts,
            "luts": luts, "module": module, "prog": es.load_serving(blob,
                                                                    "cpu"),
            "stacked": stacked, "live": live(False), "vmapped": live(True),
            "feed": (raw, fb, Ks)}


def _call(prog, raw, fb, Ks, draws):
    return prog(*prog.frame_args(raw, fb, Ks),
                torch.stack([d.prio for d in draws]),
                torch.stack([d.u for d in draws]))


def test_fleet_export_roundtrip_bit_exact(fleet):
    prog = fleet["prog"]
    assert prog.n_models == 2 and prog.batch is None
    assert prog.meta["obj_names"] == NAMES and prog.meta["poly_batch"]
    rng = np.random.default_rng(21)
    for batch in (1, 2, 3):
        raw, fb, Ks = _feed(2 * batch, rng)
        draws = [prog.draws(tfs.fleet_generator(3, 0, k, "cpu"), batch)
                 for k in range(2)]
        got = _call(prog, raw, fb, Ks, draws)
        assert got[0].shape == (2, batch, 3, 3)
        want = fleet["live"](raw, fb, Ks, fleet["stacked"], draws=draws)
        for g, w in zip(got, want[:4]):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_forwards_in_turn_match_the_vmapped_forward(fleet):
    """The artifact's forwards in turn against the vmapped forward of the
    live `test-fleet` step, on the same feed and draws."""
    raw, fb, Ks = fleet["feed"]
    draws = [fleet["prog"].draws(tfs.fleet_generator(0, 0, k, "cpu"), 2)
             for k in range(2)]
    in_turn = fleet["live"](raw, fb, Ks, fleet["stacked"], draws=draws)
    vmapped = fleet["vmapped"](raw, fb, Ks, fleet["stacked"], draws=draws)
    rows = np.ones((2, 2), bool)
    for a, b in zip(in_turn[4:], vmapped[4:]):   # masks, entire, codes
        a, b = a.numpy(), b.numpy()
        assert np.mean(a == b) >= 0.999
        rows &= (a == b).reshape(2, 2, -1).all(-1)
    assert rows.any()
    for k in range(2):
        _assert_poses([x[k] for x in in_turn[:4]],
                      [x[k].numpy() for x in vmapped[:4]], rows[k])
    # and the logits themselves
    batch = {"image": torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 2, 128, 128, 3)).astype(np.float32))}
    with torch.no_grad():
        forward = tfs.model_forward(_template())
        vm = torch.func.vmap(forward)(batch, fleet["stacked"])
        for k in range(2):
            one = forward({"image": batch["image"][k]},
                          {n: v[k] for n, v in fleet["stacked"].items()})
            for name, v in one.items():
                np.testing.assert_allclose(vm[name][k], v, atol=2e-4,
                                           rtol=0, err_msg=name)


def _template():
    with torch.device("meta"):
        return ZebraPoseNet(binary_code_length=BITS).eval()


def test_fleet_artifact_matches_jax_blob(fleet):
    raw, fb, Ks = fleet["feed"]
    jluts = [JLUT(lut.points, lut.valid, 2, BITS) for lut in fleet["luts"]]
    serve = jes.build_fleet_serving_fn(
        fleet["jmodel"], fleet["variables"], jluts,
        pnp_cfg=jpnp.PnPConfig(**PNP), use_kernel=False, **KW)
    jprog = jes.load_serving(jes.export_serving(serve, 2, (H, W),
                                                n_models=2))
    key = jax.random.PRNGKey(12)
    want = jprog(jnp.asarray(raw["rgb"]), jnp.asarray(raw["roi_param"]),
                 jnp.asarray(raw["valid"]), jnp.asarray(fb),
                 jnp.asarray(Ks), key)
    draws = [jax_ransac_draws(jax.random.split(
        jax.random.fold_in(key, k), 2), 64 * 64, PnPConfig(**PNP))
        for k in range(2)]
    got = _call(fleet["prog"], raw, fb, Ks, draws)
    out = fleet["live"](raw, fb, Ks, fleet["stacked"], draws=draws)
    for g, w in zip(got, out[:4]):               # the artifact is the step
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    compared = 0
    for k, jout in enumerate(fleet["jouts"]):
        same = []
        for g, w in ((out[4][k], j_mask(jout["mask"][..., 0])),
                     (out[6][k], j_code(jout["code"]))):
            g, w = g.numpy(), np.asarray(w)
            assert np.mean(g == w) >= 0.999
            same.append((g == w).reshape(2, -1).all(-1))
        rows = same[0] & same[1] & got[2][k].numpy() & np.asarray(
            want[2][k])
        compared += int(rows.sum())
        _assert_poses([x[k] for x in got], [x[k] for x in want], rows)
    assert compared                              # real poses are compared


def test_fleet_guards(fleet):
    prog = fleet["prog"]
    with pytest.raises(ValueError, match="serve_fleet_datasets"):
        es.serve_dataset(prog, _StubDataset())
    with pytest.raises(ValueError, match="2 models"):
        es.serve_fleet_datasets(prog, [_StubDataset()])


def _cfg(tree, **extra):
    return ZebraConfig.from_dict(dict(tree["cfg"], **extra))


@pytest.fixture(scope="module")
def cli_fleet(fleet_tree, tmp_path_factory):  # noqa: F811
    """`export-serving-fleet --f32 --batch 2` of the tree's reference
    checkpoint as the ape's and the cat's weights, at `test-fleet`'s
    RANSAC settings, and the members' architecture and stacked weights
    as `test-fleet` loads them."""
    tmp = tmp_path_factory.mktemp("cli_fleet")
    cfg_path = tmp / "cfg.txt"
    cfg_path.write_text("\n".join(f"{k} = {v}" for k, v in
                                  fleet_tree["cfg"].items()) + "\n")
    args = ["export-serving-fleet", "--cfg", str(cfg_path), "--obj_names",
            *NAMES, "--ckpt_files", fleet_tree["ckpt"], fleet_tree["ckpt"],
            "--out", str(tmp / "fleet.serving"), "--batch", "2", "--f32",
            "--image_h", str(H), "--image_w", str(W), "--device", "cpu"]
    assert cli.main(args) == 0
    model, variables = tfs._fleet_model(_cfg(fleet_tree), "v2",
                                        [fleet_tree["ckpt"]] * 2, "cpu")
    return {"args": args, "cfg_path": str(cfg_path),
            "blob": str(tmp / "fleet.serving"), "model": model,
            "variables": variables}


def test_serve_fleet_datasets_is_fleet_infer(cli_fleet, fleet_tree):  # noqa: F811
    """The test walk of the tree's ape and cat (3 and 2 frames: lockstep
    batches pad the cat) through the CLI's blob, against fleet_infer
    with the live fleet step of the same checkpoints at the same seed:
    equal, object by object."""
    cfg = _cfg(fleet_tree)
    prog = es.load_serving(cli_fleet["blob"], "cpu")
    assert prog.batch == 2 and prog.n_models == 2
    assert prog.meta["obj_names"] == NAMES and prog.meta["f32"]
    datasets = [prepare_object_eval(cfg, n).dataset for n in NAMES]
    got = es.serve_fleet_datasets(prog, datasets, seed=5)
    lp, lv = tfs.stack_luts([prepare_object_eval(cfg, n).lut
                             for n in NAMES])
    step = tfs.make_fleet_eval_step(
        tfs.model_forward(cli_fleet["model"]), lp, lv,
        pnp_cfg=PnPConfig(), vmap_forward=False, device="cpu", **KW)
    want = tfs.fleet_infer(datasets, step, cli_fleet["variables"], 2,
                           seed=5, device="cpu")
    for g, w in zip(got, want[:3]):
        for gk, wk in zip(g, w):
            np.testing.assert_array_equal(gk, wk)
    assert [len(x) for x in got[0]] == [3, 2]


def test_serve_exported_fleet_and_vivo_fleet(cli_fleet, fleet_tree,  # noqa: F811
                                             tmp_path, capsys):
    blob_fn = cli_fleet["blob"]
    cfg = _cfg(fleet_tree)
    out = str(tmp_path / "out")
    res = es.run_serve_exported_fleet(cfg, NAMES, blob_fn, out, seed=3,
                                      device="cpu")
    assert res["instances"] == {"ape": 3, "cat": 2} and res["batch"] == 2
    merged = open(res["merged_csv"]).read().splitlines()
    assert len(merged) == 1 + 5              # failed poses stay (identity)

    out_v = str(tmp_path / "out_vivo")
    capsys.readouterr()
    assert cli.main(["serve-exported-fleet", "--cfg", cli_fleet["cfg_path"],
                     "--obj_names", *NAMES, "--blob", blob_fn, "--vivo",
                     "--seed", "3", "--output_dir", out_v,
                     "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["per_object"]["ape"]["instances"] == 4
    assert res["per_object"]["cat"]["instances"] == 2
    merged = open(res["merged_csv"]).read().splitlines()
    assert len(merged) == 1 + sum(res["per_object"][n]["solved"]
                                  for n in NAMES)
    assert os.path.exists(os.path.join(out_v, "pose_result_bop",
                                       "lmo_cat.csv"))

    # a fleet blob is refused by the single-object drivers
    with pytest.raises(ValueError, match="fleet artifact"):
        es.run_serve_exported_vivo(cfg, "ape", blob_fn, out, device="cpu")
    with pytest.raises(ValueError, match="fleet artifact"):
        es.run_serve_exported(cfg, "ape", blob_fn, out, device="cpu")
    # the object count must match the blob's model axis
    with pytest.raises(ValueError, match="serves 2 models"):
        es.run_serve_exported_vivo_fleet(cfg, ["ape"], blob_fn, out,
                                         device="cpu")
    # an object with no detection cannot be skipped from a fleet blob
    dets = json.load(open(fleet_tree["cfg"]["Detection_reaults"]))
    no_cat = {k: [d for d in v if d["obj_id"] != 6] for k, v in dets.items()}
    det_fn = tmp_path / "dets_nocat.json"
    det_fn.write_text(json.dumps(no_cat))
    with pytest.raises(ValueError, match="cannot skip"):
        es.run_serve_exported_vivo_fleet(
            _cfg(fleet_tree, Detection_reaults=str(det_fn)), NAMES,
            blob_fn, out, device="cpu")


def test_cli_export_serving_fleet_guards(cli_fleet):
    args = cli_fleet["args"]
    with pytest.raises(SystemExit, match="one checkpoint per object"):
        cli.main(args[:7] + args[8:])
    with pytest.raises(SystemExit, match="device it was exported on"):
        cli.main(args + ["--platforms", "cpu"])
