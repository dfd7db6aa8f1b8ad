"""The port's `export-ckpt`, `model-cost`, `train_step_cost`,
`tools/fibonacci_code.py`, the compact-checkpoint writer and the numpy
helpers no path calls, against the JAX package on the CPU.

Tolerances and why:
  * export: exact. The reference `.pth` is the same dict as the JAX
    package's `save_reference_checkpoint` writes: the same keys, dtypes
    (float32 leaves, 0-d int64 `num_batches_tracked`) and values, and
    the same `iteration_step` / `best_score`; it strict-loads into the
    port's `load_model`. ResNet50 is held on a tree of the real key
    structure with one-element leaves (the mapping does not look at
    widths; its real leaves are 1.4 GB) and on the key set and shapes
    of the port's model on the meta device.
  * model-cost: parameters exactly equal to the JAX package's count for
    every flag combination. FLOPs: `torch.utils.flop_counter` counts
    every tap of a convolution, XLA's cost analysis leaves out the taps
    that fall in the padding (a 3x3 dilation-12 conv on an 8² map: XLA
    0.52 MFLOP, torch 4.72) and counts elementwise ops. Measured: torch
    / XLA = 1.348 (v2), 1.257 (v3), 1.353 (no concat) at 64², where the
    ASPP's dilated taps fall in the padding most; the test holds the 64²
    ratio within 1.20-1.40.
  * train_step_cost: 2.5-3x the eval forward's FLOPs at the same batch
    (measured 2.997x: a backward is the two products of each conv, one
    fewer for the stem's input), and res.state bit-equal afterwards.
  * fibonacci, voc_ap, split_batch_sizes, ycbv_select_keyframes,
    save_compact: exact (the same numpy; bf16 rounding as ml_dtypes).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from test_torch_trainer import (  # noqa: F401  (fixtures)
    _hide_module_stubs,
    _write_cfg,
    tree,
)
from torch_oracle import ReferenceNet
from zebrapose_tpu import cli as jcli
from zebrapose_tpu.models import convert_torch as jconvert
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval.runner import load_model
from zebrapose_tpu_torch.models import convert
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.utils import compact_ckpt, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "trained", "rehearsal3_best.npz")

@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints here are 0.1-0.35 GB each: a test's files go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# family -> (ZebraPoseNet kwargs, config keys)
FAMILIES = {
    "v2": (dict(binary_code_length=16, variant="v2"), {}),
    "v3": (dict(binary_code_length=16, variant="v3"), {}),
    "base4": (dict(binary_code_length=8, base=4, variant="v1"),
              dict(divide_number_each_itration=4, number_of_itration=8,
                   BinaryCode_Loss_Type="CE",
                   use_histgramm_weighted_binary_loss=False)),
    "resnet50": (dict(binary_code_length=16, variant="v2",
                      resnet_layers=50), dict(resnet_layer=50)),
}


def _family_kw(kw):
    return dict(variant=kw["variant"], nonbinary=kw.get("base", 2) != 2,
                resnet_layers=kw.get("resnet_layers", 34))


def _same_checkpoint(a, b):
    """Two .pth files hold the same reference dict, tensor for tensor."""
    pa = torch.load(a, map_location="cpu", weights_only=True)
    pb = torch.load(b, map_location="cpu", weights_only=True)
    assert sorted(pa) == sorted(pb) == ["best_score", "iteration_step",
                                        "model_state_dict"]
    assert (pa["iteration_step"], pa["best_score"]) == \
        (pb["iteration_step"], pb["best_score"])
    assert type(pa["iteration_step"]) is type(pb["iteration_step"]) is int
    sa, sb = pa["model_state_dict"], pb["model_state_dict"]
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k], sb[k]), k
    return sa


@pytest.mark.parametrize("name", ["v2", "v3", "base4"])
def test_save_reference_checkpoint_equals_jax(name, tmp_path):
    kw, cfg_keys = FAMILIES[name]
    variables = flax_variables(kw["variant"], np.random.default_rng(3),
                               n_bits=kw["binary_code_length"],
                               **{k: v for k, v in kw.items()
                                  if k not in ("variant",
                                               "binary_code_length")})
    fam = _family_kw(kw)
    args = dict(iteration_step=1234, best_score=0.625, **fam)
    jconvert.save_reference_checkpoint(str(tmp_path / "jax.pth"),
                                       variables, **args)
    convert.save_reference_checkpoint(str(tmp_path / "port.pth"),
                                      variables, **args)
    sd = _same_checkpoint(str(tmp_path / "jax.pth"),
                          str(tmp_path / "port.pth"))
    bn = [k for k in sd if k.endswith("num_batches_tracked")]
    assert bn and all(sd[k].dtype == torch.int64 and sd[k].ndim == 0
                      and int(sd[k]) == 0 for k in bn)
    assert any(k.startswith("net.resnet.resnet_layer_1.") for k in sd)
    # strict into the port's model, and the weights are the variables'
    cfg = ZebraConfig.from_dict(
        {"number_of_itration": kw["binary_code_length"], **cfg_keys})
    model = load_model(cfg, str(tmp_path / "port.pth"), kw["variant"],
                       device="cpu")
    want = convert.variables_to_state_dict(variables, **fam)
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    # without the skip-tap aliases, as a concat_decoder = False module
    jconvert.save_reference_checkpoint(str(tmp_path / "jax.pth"),
                                       variables, concat=False, **args)
    convert.save_reference_checkpoint(str(tmp_path / "port.pth"),
                                      variables, concat=False, **args)
    sd = _same_checkpoint(str(tmp_path / "jax.pth"),
                          str(tmp_path / "port.pth"))
    assert not any(".resnet_layer_" in k for k in sd)


def test_resnet50_export_equals_jax_and_fits_the_model(tmp_path):
    """ResNet50: both exporters on the family's real tree structure with
    one-element leaves (values distinct per leaf), then the exported key
    set and the real shapes against the port's model (meta device)."""
    kw, _ = FAMILIES["resnet50"]
    shapes = jax.eval_shape(
        lambda k: JNet(**kw).init(k, jnp.zeros((1, 64, 64, 3)),
                                  train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    tiny = jax.tree.map(
        lambda s: rng.normal(size=(1,) * len(s.shape)).astype(np.float32),
        dict(shapes))
    fam = _family_kw(kw)
    jconvert.save_reference_checkpoint(str(tmp_path / "jax.pth"), tiny,
                                       **fam)
    convert.save_reference_checkpoint(str(tmp_path / "port.pth"), tiny,
                                      **fam)
    sd = _same_checkpoint(str(tmp_path / "jax.pth"),
                          str(tmp_path / "port.pth"))
    real = convert.export_reference_state_dict(
        jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                     dict(shapes)), **fam)
    with torch.device("meta"):
        model = ZebraPoseNet(**kw)
    own = model.state_dict()
    assert sorted(sd) == sorted(real) == sorted(own)
    for k, v in own.items():
        assert tuple(real[k].shape) == tuple(v.shape), k


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("source", ["npz", "pth"])
def test_export_ckpt_command_equals_jax(source, tmp_path, capsys):
    """`export-ckpt` of the committed .npz (v2, 16 bits) and of a
    reference .pth (DDP prefixes, no skip-tap aliases): the port's file
    equals the JAX command's and strict-loads into `test`'s model."""
    if source == "npz":
        ckpt = CKPT
    else:
        torch.manual_seed(2)
        sd = {"module." + k: v for k, v in
              ReferenceNet("v2", 16).state_dict().items()
              if ".resnet_layer_" not in k}
        ckpt = str(tmp_path / "ref.pth")
        torch.save({"model_state_dict": sd}, ckpt)
    flags = ["--ckpt_file", ckpt, "--step", "77", "--best_score", "0.5"]
    _run(jcli.main, ["export-ckpt", "--out", str(tmp_path / "jax.pth")]
         + flags, capsys)
    out = _run(cli.main, ["export-ckpt", "--out", str(tmp_path / "p.pth"),
                          "--device", "cpu"] + flags, capsys)
    assert f"-> {tmp_path / 'p.pth'}" in out
    _same_checkpoint(str(tmp_path / "jax.pth"), str(tmp_path / "p.pth"))
    model = load_model(ZebraConfig.from_dict({}), str(tmp_path / "p.pth"),
                       device="cpu")
    want = load_model(ZebraConfig.from_dict({}), ckpt, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              want.state_dict().items()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


def test_export_ckpt_refuses_orbax_directories(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="zebrapose_tpu export-ckpt"):
        cli.main(["export-ckpt", "--ckpt_file", str(tmp_path), "--out",
                  str(tmp_path / "x.pth"), "--device", "cpu"])


def test_state_dict_to_variables_inverts_the_export():
    """`.pth` -> variables (the port's copy of JAX's
    convert_reference_state_dict) equals JAX's import, leaf for leaf."""
    torch.manual_seed(4)
    sd = ReferenceNet("v3", 16).state_dict()
    want = jconvert.convert_reference_state_dict(sd, variant="v3")
    got = convert.state_dict_to_variables(sd, "v3")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf))
    assert convert.reference_family(sd) == ("v3", False, 34)
    assert convert.reference_family(
        {"module.net.aspp.conv_1x1_4_mask.weight": 0,
         "net.resnet.resnet.4.0.conv3.weight": 0}) == ("v2", True, 50)


_COST_FLAGS = [dict(variant=v, resnet_layers=r, code_length=c, concat=cc)
               for v in ("v1", "v2", "v3") for r in (34, 50)
               for c in (16, 8) for cc in (True, False)
               if not (v == "v3" and r == 50)]


@pytest.mark.parametrize("flags", _COST_FLAGS, ids=lambda f: "-".join(
    str(v) for v in f.values()))
def test_model_cost_params_equal_jax(flags):
    """Parameter counts of every --variant / --resnet_layers /
    --code_length / --no_concat combination (shapes only: the port's
    model on the meta device, JAX's through eval_shape; the crop does
    not change a count)."""
    kw = dict(binary_code_length=flags["code_length"],
              variant=flags["variant"],
              resnet_layers=flags["resnet_layers"], concat=flags["concat"])
    shapes = jax.eval_shape(
        lambda k: JNet(**kw).init(k, jnp.zeros((1, 64, 64, 3)),
                                  train=False), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = ZebraPoseNet(**kw)
    cost = profiling.model_cost(model, torch.zeros((1, 64, 64, 3),
                                                   device="meta"))
    assert cost["params"] == want
    assert cost["flops"] > 0


@pytest.mark.parametrize("argv", [[], ["--variant", "v3"], ["--no_concat"]])
def test_model_cost_command_against_jax(argv, capsys):
    """The JSON line of both commands at 64²: params_M equal, the FLOP
    ratio inside the measured band (module docstring)."""
    argv = ["model-cost", "--crop", "64"] + argv
    want = json.loads(_run(jcli.main, argv, capsys).splitlines()[-1])
    got = json.loads(_run(cli.main, argv + ["--device", "cpu"],
                          capsys).splitlines()[-1])
    assert sorted(got) == sorted(want) == ["flops_G", "params_M"]
    assert got["params_M"] == want["params_M"]
    assert 1.20 <= got["flops_G"] / want["flops_G"] <= 1.40, (got, want)


def test_flop_counts_differ_by_the_padded_taps():
    """A 3x3 conv of dilation 12 on an 8² map, 64 -> 64 channels: torch
    counts its 9 taps at every pixel, XLA leaves out the taps that fall
    in the padding (8 of the 9 here)."""
    x, w = jnp.zeros((1, 8, 8, 64)), jnp.zeros((3, 3, 64, 64))
    cost = jax.jit(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), [(12, 12)] * 2, rhs_dilation=(12, 12),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))).lower(
        x, w).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    got = profiling.count_flops(
        torch.nn.functional.conv2d, torch.zeros(1, 64, 8, 8),
        torch.zeros(64, 64, 3, 3), None, 1, 12, 12)
    assert got == 2 * 64 * 64 * 9 * 64 == 4718592
    assert cost["flops"] == 2 * 64 * 64 * 1 * 64 == 524288


def test_count_flops_gives_custom_ops_no_formula():
    """The EPnP custom op counts 0 (no formula); a matmul counts 2
    a multiply-add."""
    import zebrapose_tpu_torch.ops.pnp_kernel  # noqa: F401  (the op)

    x = torch.zeros(4, 6, 3)
    assert profiling.count_flops(
        lambda: torch.ops.zebrapose.epnp_minimal_hypotheses(
            x, torch.zeros(4, 6, 2), torch.eye(3).expand(4, 3, 3)
            .contiguous(), 5)) == 0
    assert profiling.count_flops(torch.matmul, torch.zeros(3, 5),
                                 torch.zeros(5, 7)) == 2 * 3 * 5 * 7


def test_train_step_cost_leaves_the_state_bit_equal(tree, tmp_path):
    from zebrapose_tpu_torch.train import trainer

    cfg = ZebraConfig.from_file(_write_cfg(tree, tmp_path / "cfg.txt"))
    res = trainer.build_train_setup(cfg, "ape", str(tmp_path / "run"),
                                    pretrained_backbone=None, device="cpu")
    try:
        # one step first: the Adam moments exist, so the check covers them
        trainer._one_step(res, trainer._make_batch_fn(res), 0,
                          trainer._loss_cfg(cfg))
        before = {k: v.clone() for k, v in
                  res.state.model.state_dict().items()}
        opt = res.state.optimizer.state_dict()
        opt_before = {i: {k: v.clone() for k, v in s.items()}
                      for i, s in opt["state"].items()}
        assert opt_before
        hist, step = res.state.histogram.clone(), res.state.step
        cost = trainer.train_step_cost(res)
        fwd = profiling.model_cost(
            ZebraPoseNet(binary_code_length=16),
            torch.zeros((cfg.batch_size, 32, 32, 3)))["flops"]
        assert sorted(cost) == ["flops"]
        assert 2.5 * fwd <= cost["flops"] <= 3.0 * fwd, (cost, fwd)
        for k, v in res.state.model.state_dict().items():
            assert torch.equal(v, before[k]), k
        after = res.state.optimizer.state_dict()["state"]
        for i, s in opt_before.items():
            for k, v in s.items():
                assert torch.equal(after[i][k], v), (i, k)
        assert torch.equal(res.state.histogram, hist)
        assert res.state.step == step
        assert all(p.grad is None for p in res.state.model.parameters())
    finally:
        res.train_iter.close()
        res.ckpt.close()
        res.logger.close()


def test_fibonacci_and_helpers_equal_jax(tmp_path):
    from zebrapose_tpu.data import bop_io as jbop
    from zebrapose_tpu.ops import binarize as jbin
    from zebrapose_tpu.ops import metrics as jmet
    from zebrapose_tpu.tools import fibonacci_code as jfib
    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.ops import binarize, metrics
    from zebrapose_tpu_torch.tools import fibonacci_code as fib

    np.testing.assert_array_equal(fib.fibonacci_sphere(97),
                                  jfib.fibonacci_sphere(97))
    pts = fib.fibonacci_sphere(64)
    for seed in (0, 3):
        got = fib.anneal_code_assignment(pts, 7, iterations=600, seed=seed)
        want = jfib.anneal_code_assignment(pts, 7, iterations=600,
                                           seed=seed)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    pairs = fib._knn_pairs(pts)
    np.testing.assert_array_equal(pairs, jfib._knn_pairs(pts))
    assert fib.locality_cost(got[0], pairs) == \
        jfib.locality_cost(got[0], pairs)

    rng = np.random.default_rng(8)
    for _ in range(5):
        rec = np.sort(rng.uniform(0, 0.1, 20))
        rec[rng.integers(0, 20, 3)] = np.inf
        prec = rng.uniform(0, 1, 20)
        assert metrics.voc_ap(rec, prec) == jmet.voc_ap(rec, prec)
    assert metrics.voc_ap(np.full(3, np.inf), np.ones(3)) == 0.0
    for ratio in (0.0, 0.25, 0.75, 1.0):
        for bs in (1, 7, 32):
            assert binarize.split_batch_sizes(ratio, bs) == \
                jbin.split_batch_sizes(ratio, bs)

    class Samples:
        rgb_files = [[os.path.join("d", "test", f"{s:06d}", "rgb",
                                   f"{i:06d}.png")
                      for s, i in ((48, 1), (48, 7), (49, 1), (50, 2))]]

    keyframes = tmp_path / "keyframe.txt"
    keyframes.write_text("0048/000001\n0049/000001\n\n0051/000002\n")
    assert bop_io.ycbv_select_keyframes(Samples, 1, str(keyframes)) == \
        jbop.ycbv_select_keyframes(Samples, 1, str(keyframes)) == [0, 2]


def test_save_compact_equals_jax(tmp_path):
    """The .npz of both writers, array for array, with bf16 rounding
    ties, NaN, infinities and float32 extremes; the port reads both."""
    from zebrapose_tpu.utils import compact_ckpt as jcc

    rng = np.random.default_rng(9)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.4028235e38, -3.4028235e38, 1e-45, 1.00390625,
                        1.01171875, -1.00390625], np.float32)
    tree = {"params": {"a": {"kernel": rng.normal(size=(3, 3, 4, 5))
                             .astype(np.float32)},
                       "s": special},
            "batch_stats": {"steps": np.arange(3, dtype=np.int64),
                            "h": rng.normal(size=7).astype(np.float16)}}
    bits = special.view(np.uint32)
    ties = np.array([0x3F808000, 0x3F818000], np.uint32).view(np.float32)
    tree["params"]["ties"] = ties
    assert bits.dtype == np.uint32
    meta = {"step": 3, "best_score": "0.5 step 3"}
    jcc.save_compact(tree, str(tmp_path / "jax.npz"), meta)
    compact_ckpt.save_compact(tree, str(tmp_path / "port.npz"), meta)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, got_meta = compact_ckpt.load_compact(str(tmp_path / "port.npz"))
    assert got_meta == meta
    want, _ = jcc.load_compact(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(got["params"]["a"]["kernel"],
                                  want["params"]["a"]["kernel"])


def test_save_compact_from_run_writes_the_best_checkpoint(tmp_path):
    """A port run dir's best .pth (v3 here: the family is read off the
    keys) -> a compact .npz whose weights are that checkpoint's at bf16
    and whose meta is JAX's."""
    torch.manual_seed(6)
    sd = ReferenceNet("v3", 16).state_dict()
    best = tmp_path / "run" / "checkpoints" / "best"
    best.mkdir(parents=True)
    for step in (9, 12):
        torch.save({"model_state_dict": sd, "iteration_step": step},
                   best / f"step_{step}.pth")
    (best / "best_score.txt").write_text("0.75 step 12\n")
    meta = compact_ckpt.save_compact_from_run(str(tmp_path / "run"),
                                              str(tmp_path / "c.npz"))
    assert meta == {"step": 12, "best_score": "0.75 step 12"}
    variables, got_meta = compact_ckpt.load_compact(str(tmp_path / "c.npz"))
    assert got_meta == meta
    want = convert.state_dict_to_variables(sd, "v3")
    for (path, leaf), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(variables),
            jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(leaf, compact_ckpt.bf16_bits_to_f32(
            compact_ckpt.f32_to_bf16_bits(w)), err_msg=str(path))
