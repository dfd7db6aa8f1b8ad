"""Port parity for the model families beyond v1 / v2 on ResNet34: v3 (the
mask-conditioned second decoder), ResNet50 and the base-4 CE head, on
the CPU against the JAX package.

Weights come from a torch oracle of the reference topology
(tests/torch_oracle.py; the base-4 head is built in this file on its
modules), pass through the JAX package's `convert_reference_state_dict`
and then the port's `variables_to_state_dict`. One 64² forward a family on the
JAX side, shared by a module-scope fixture.

Tolerances and why:
  * forward: 2e-4 absolute (5e-4 for ResNet50), JAX's own in
    tests/test_model_parity.py: float32 convolutions in another order,
    through 30-50 layers.
  * state dicts: key sets and values exactly (a copy).
  * one CE train step on base 4 with the network in float64: each
    gradient tensor within 1e-4 relative L2, grad_norm within 1e-6 and
    the BN running statistics within 1e-5, as tests/test_torch_train.py
    holds BCE; the losses within 2e-5
    relative: both stacks compute them in float32 (total_loss casts the
    logits), and CE's mean of 2 x 16 x 16 x 8 log-softmax terms summed in
    another order differs by ~sqrt(4096) float32 ulps.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_threads  # noqa: F401  (torch threads a worker)
import torch_oracle
from test_torch_model import flax_variables
from test_torch_trainer import tree  # noqa: F401
from zebrapose_tpu.models.convert_torch import (
    convert_reference_state_dict,
    convert_torchvision_resnet34,
    merge_pretrained,
    strip_ddp_prefix,
)
from zebrapose_tpu.models.losses import CodeLossConfig as JLossCfg
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.train import state as jstate
from zebrapose_tpu.train import train_step as jts
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    save_correspondence_lut,
)
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval.runner import load_model
from zebrapose_tpu_torch.models.convert import (
    load_torchvision_resnet34,
    variables_to_state_dict,
)
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.train import train_step as tts
from zebrapose_tpu_torch.train.state import create_train_state


class _NonBinaryDecoder(torch_oracle.Decoder):
    """The reference's DeepLabV3_non_binary decoder: the ASPP trunk with
    split mask / code output convs."""

    def __init__(self, code_len, base):
        super().__init__(1)
        del self.conv_1x1_4
        self.conv_1x1_4_mask = nn.Conv2d(256 + 64, 1, 1)
        self.conv_1x1_4_code = nn.Conv2d(256 + 64, code_len * base, 1)

    def forward(self, xh, x_128, x_64):
        outs = self.trunk(xh, ["conv_1x1_1", "conv_3x3_1", "conv_3x3_2",
                               "conv_3x3_3"])
        y = F.relu(self.bn_conv_1x1_3(self.conv_1x1_3(torch.cat(outs, 1))))
        y = self.upsample_1(y)
        y = self.upsample_2(torch.cat([y, x_64], 1))
        y = torch.cat([y, x_128], 1)
        return self.conv_1x1_4_mask(y), self.conv_1x1_4_code(y)


class NonBinaryNet(nn.Module):
    """Key-compatible stand-in for the reference's non-binary model."""

    def __init__(self, code_len=8, base=4):
        super().__init__()

        class Inner(nn.Module):
            def __init__(self):
                super().__init__()
                self.resnet = torch_oracle.Backbone()
                self.aspp = _NonBinaryDecoder(code_len, base)

            def forward(self, x):
                xh, x_128, x_64, _, _ = self.resnet(x)
                return self.aspp(xh, x_128, x_64)

        self.net = Inner()

    def forward(self, x):
        return self.net(x)


# family -> (oracle maker, ZebraPoseNet kwargs, output names, tolerance)
FAMILIES = {
    "v3": (lambda: torch_oracle.ReferenceNet("v3", 16),
           dict(binary_code_length=16, variant="v3"),
           ("mask", "entire_mask", "code"), 2e-4),
    "resnet50": (lambda: torch_oracle.ReferenceNet50(16),
                 dict(binary_code_length=16, variant="v2", resnet_layers=50),
                 ("mask", "entire_mask", "code"), 5e-4),
    "base4": (lambda: NonBinaryNet(8, 4),
              dict(binary_code_length=8, base=4, variant="v1"),
              ("mask", "code"), 2e-4),
}


def _randomize_bn(net, seed):
    """BatchNorm statistics and affine parameters off the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                m.weight.copy_(torch.rand(n, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)


def _convert_kw(kw):
    return dict(variant=kw["variant"], nonbinary=kw.get("base", 2) != 2,
                resnet_layers=kw.get("resnet_layers", 34))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, oracle, its outputs on x, JAX's outputs on x, the port
    state dict carried from the JAX variables, x NHWC) for one family."""
    name = request.param
    make, kw, names, _ = FAMILIES[name]
    torch.manual_seed(42)
    oracle = make().eval()
    _randomize_bn(oracle, 5)
    x = np.random.default_rng(21).normal(size=(1, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = dict(zip(names, (w.numpy().transpose(0, 2, 3, 1) for w in want)))
    ckw = _convert_kw(kw)
    variables = convert_reference_state_dict(
        strip_ddp_prefix(oracle.state_dict()), **ckw)
    jout = JNet(**kw).apply(variables, jnp.asarray(x), train=False)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    sd = variables_to_state_dict(variables, **ckw)
    return name, oracle, want, jout, sd, x


def test_forward_matches_jax_and_the_oracle(family):
    name, _, want, jout, sd, x = family
    _, kw, names, tol = FAMILIES[name]
    model = ZebraPoseNet(**kw).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}
    assert sorted(got) == sorted(jout) == sorted(names)
    for k in names:
        assert got[k].shape == jout[k].shape, k
        assert np.abs(got[k] - jout[k]).max() < tol, (name, k)
        assert np.abs(got[k] - want[k]).max() < tol, (name, k)
    if name == "base4":
        assert got["code"].shape[-1] == 8 * 4


def test_state_dicts_load_strictly_both_ways(family):
    """The carried state dict holds the oracle's weights under the
    oracle's keys, so each loads the other's strictly."""
    name, oracle, _, _, sd, _ = family
    _, kw, _, _ = FAMILIES[name]
    model = ZebraPoseNet(**kw)
    model.load_state_dict(sd, strict=True)
    theirs = oracle.state_dict()
    assert sorted(model.state_dict()) == sorted(theirs)
    for k, v in theirs.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    fresh = FAMILIES[name][0]()
    fresh.load_state_dict(model.state_dict(), strict=True)


def _family_cfg(name, **extra):
    """A ZebraConfig of the family's keys (the config file's view)."""
    _, kw, _, _ = FAMILIES[name]
    d = {"number_of_itration": kw["binary_code_length"],
         "divide_number_each_itration": kw.get("base", 2),
         "resnet_layer": kw.get("resnet_layers", 34)}
    if kw.get("base", 2) != 2:
        d.update(BinaryCode_Loss_Type="CE",
                 use_histgramm_weighted_binary_loss=False)
    return ZebraConfig.from_dict(dict(d, **extra))


def test_reference_pth_of_each_family_loads(family, tmp_path):
    """A reference-format .pth of the family, DDP-prefixed as train_v5
    saves it, loads strictly through the runner's `load_model` (the
    config's resnet_layer and base, reference_state_dict) and gives the
    oracle's outputs."""
    name, oracle, want, _, _, x = family
    _, kw, names, tol = FAMILIES[name]
    path = str(tmp_path / f"{name}.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in
                                     oracle.state_dict().items()}}, path)
    model = load_model(_family_cfg(name), path, kw["variant"],
                       device="cpu")
    os.remove(path)                     # ResNet50's is 1.4 GB
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in names:
        assert np.abs(got[k].numpy() - want[k]).max() < tol, (name, k)


@pytest.mark.parametrize("name", ["v3", "base4"])
def test_compact_npz_of_each_family_loads(name, tmp_path):
    """A compact .npz the JAX package writes for the family loads
    through the runner (`load_model_variables` passes the family to
    variables_to_state_dict) into the weights JAX reads back from it."""
    from zebrapose_tpu.utils.compact_ckpt import (
        load_compact as j_load_compact,
        save_compact,
    )

    _, kw, _, _ = FAMILIES[name]
    variables = JNet(**kw).init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 64, 64, 3)), train=False)
    path = str(tmp_path / f"{name}.npz")
    save_compact(jax.tree.map(np.asarray, dict(variables)), path)
    model = load_model(_family_cfg(name), path, kw["variant"],
                       device="cpu")
    want = variables_to_state_dict(j_load_compact(path)[0],
                                   **_convert_kw(kw))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].reshape(-1),
                           v.reshape(-1).to(got[k].dtype)), k


def _detections(bop_path):
    """A detections JSON of the tree's test split: each frame's GT box
    at 0.9."""
    scene = os.path.join(bop_path, "lmo", "test", "000002")
    with open(os.path.join(scene, "scene_gt_info.json")) as f:
        info = json.load(f)
    dets = {f"2/{im}": [{"obj_id": 1, "bbox_est": rows[0]["bbox_visib"],
                         "score": 0.9}] for im, rows in info.items()}
    path = os.path.join(os.path.dirname(bop_path), "det.json")
    with open(path, "w") as f:
        json.dump(dets, f)
    return path


@pytest.mark.parametrize("name", ["v3", "base4"])
def test_train_test_and_vivo_take_each_family(tree, tmp_path, name):
    """`train --variant` from scratch for 2 steps with a pose validation
    (its histogram one entry a digit), then `test` on the checkpoint
    (v3 with refine = True) and `vivo`, all on the CPU. Base 4 gets a
    base-4 surface code (4^8 classes) in a copy of the tree. (ResNet50's
    Adam state is 4 GB: it trains on the card, in chip_smoke.py.)"""
    bop_path, d = tree
    if name == "base4":
        bop_path = str(tmp_path / "bop")
        shutil.copytree(tree[0], bop_path, symlinks=True)
        rng = np.random.default_rng(5)
        valid = rng.random(4 ** 8) < 0.3
        save_correspondence_lut(
            os.path.join(bop_path, "lmo", "models_GT_color",
                         "Class_CorresPoint000001.txt"),
            CorrespondenceLUT(rng.uniform(-30, 30, (4 ** 8, 3)).astype(
                np.float32) * valid[:, None], valid, 4, 8))
    cfg = _family_cfg(name, **dict(d, bop_path=bop_path,
                                   batch_size=2)).to_dict()
    cfg_path = tmp_path / "cfg.txt"
    keys = set(d) | {"number_of_itration", "divide_number_each_itration",
                     "resnet_layer", "BinaryCode_Loss_Type",
                     "use_histgramm_weighted_binary_loss", "batch_size"}
    cfg_path.write_text("".join(f"{k} = {cfg[k]}\n" for k in sorted(keys)))
    variant = FAMILIES[name][1]["variant"]
    out = tmp_path / "runs"
    assert cli.main(["train", "--cfg", str(cfg_path), "--obj_name", "ape",
                     "--variant", variant, "--device", "cpu",
                     "--from_scratch", "--max_steps", "2", "--log_freq",
                     "2", "--output_dir", str(out)]) == 0
    run = out / "lmo_ape"
    rows = [json.loads(ln) for ln in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert any(r["tag"] == "val/ADD_recall_0.1d" for r in rows)
    bits = {r["tag"] for r in rows if r["tag"].startswith("train/bit_err_")}
    assert bits == {f"train/bit_err_{i}" for i in
                    range(FAMILIES[name][1]["binary_code_length"])}
    ckpt = str(run / "checkpoints" / "steps" / "step_2.pth")
    test_cfg = tmp_path / "test_cfg.txt"
    test_cfg.write_text(cfg_path.read_text()
                        + ("refine = True\n" if name == "v3" else ""))
    assert cli.main(["test", "--cfg", str(test_cfg), "--obj_name", "ape",
                     "--ckpt_file", ckpt, "--variant", variant,
                     "--batch_size", "2", "--device", "cpu",
                     "--output_dir", str(tmp_path / "test")]) == 0
    (run_dir,) = os.listdir(tmp_path / "test")
    csv = tmp_path / "test" / run_dir / "pose_result_bop" / "lmo_ape.csv"
    assert len(csv.read_text().splitlines()) == 4
    vivo_cfg = tmp_path / "vivo_cfg.txt"
    vivo_cfg.write_text(cfg_path.read_text() + "Detection_reaults = "
                        + _detections(bop_path) + "\n")
    assert cli.main(["vivo", "--cfg", str(vivo_cfg), "--obj_name", "ape",
                     "--ckpt_file", ckpt, "--variant", variant,
                     "--batch_size", "2", "--device", "cpu",
                     "--output_dir", str(tmp_path / "vivo")]) == 0
    shutil.rmtree(run / "checkpoints")  # ~0.4 GB with the Adam state


@pytest.mark.parametrize("kw", [dict(variant="v3", resnet_layers=50),
                                dict(variant="v1", base=4,
                                     binary_code_length=8,
                                     resnet_layers=50)])
def test_resnet50_refuses_v3_and_nonbinary_as_jax_does(kw):
    with pytest.raises(NotImplementedError, match="resnet_layers=34"):
        ZebraPoseNet(**kw)
    with pytest.raises(NotImplementedError, match="resnet_layers=34"):
        JNet(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


def test_resnet34_imagenet_weights_do_not_fit_resnet50_in_either():
    """load_torchvision_resnet34 on a ResNet50 model fails with a shape
    error at the first Bottleneck conv, as JAX's merge_pretrained does:
    neither package has a ResNet50 ImageNet loader. (Shapes only: the
    port's model on the meta device, JAX's variables by eval_shape.)"""
    sd = torch_oracle.fake_torchvision_resnet34_state_dict()
    with torch.device("meta"):
        model = ZebraPoseNet(binary_code_length=16, resnet_layers=50)
    with pytest.raises(ValueError, match="shape mismatch at layer1.0.conv1"):
        load_torchvision_resnet34(model, sd)
    jv = jax.eval_shape(lambda: JNet(binary_code_length=16,
                                     resnet_layers=50).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    with pytest.raises(ValueError, match="shape mismatch at "
                       "resnet/layer1_0/conv1"):
        merge_pretrained(dict(jv), convert_torchvision_resnet34(sd))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


@pytest.fixture(autouse=True)
def _hide_module_stubs():
    """tests/test_real_reference_module.py's stub `imgaug` modules trip
    torch._dynamo's walk of sys.modules on the first optimizer (see
    tests/test_torch_train.py); hide them while a test runs."""
    stubs = {k: sys.modules.pop(k) for k in ("imgaug", "imgaug.augmenters")
             if k in sys.modules}
    yield
    sys.modules.update(stubs)


def test_ce_train_step_on_base4_matches_jax_in_float64():
    """One optimizer step of the base-4 family with the CE code loss (8
    digits, 32 code channels, histogram weighting off as the config
    requires for CE), the network in float64 in both stacks: the losses,
    grad_norm, every gradient tensor and the BN running statistics. (A
    second step is not compared: Adam's first update moves a weight whose
    gradient is zero in exact arithmetic, and ~1e-18 in float64, by +-lr
    with the sign of that rounding.)"""
    variables = flax_variables("v1", np.random.default_rng(3), n_bits=8,
                               base=4)
    rng = np.random.default_rng(4)
    batch = {
        "image": rng.normal(size=(2, 32, 32, 3)),
        "mask": (rng.random((2, 16, 16)) > 0.5).astype(np.float64),
        "entire_mask": (rng.random((2, 16, 16)) > 0.3).astype(np.float64),
        "code": rng.integers(0, 4, (2, 16, 16, 8)).astype(np.float64),
    }
    lk = dict(loss_type="CE", use_histogram_weighting=False, base=4,
              n_bits=8)
    cfg_j, cfg_t = JLossCfg(**lk), CodeLossConfig(**lk)
    model = ZebraPoseNet(binary_code_length=8, base=4, variant="v1")
    model.load_state_dict(variables_to_state_dict(
        variables, "v1", nonbinary=True), strict=True)
    ts = create_train_state(model.double(), 2e-4, n_bits=8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts.optimizer.zero_grad(set_to_none=True)
    tm = tts.grad_step(ts, tb, cfg_t)
    grads = {n: p.grad.clone() for n, p in ts.model.named_parameters()}
    tm["grad_norm"] = tts.apply_accumulated(ts, 1)
    with jax.enable_x64(True):
        js = jstate.create_train_state(
            JNet(binary_code_length=8, base=4, variant="v1",
                 dtype=jnp.float64),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
            learning_rate=2e-4, n_bits=8)
        jb = jax.tree.map(jnp.asarray, batch)
        js, jm = jts.train_step(js, jb, cfg_j)
        jgrads = variables_to_state_dict(
            {"params": jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                    js.opt_state[0].mu),
             "batch_stats": jax.tree.map(np.asarray, js.batch_stats)},
            "v1", nonbinary=True)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert _rel(tm[k].item(), float(jm[k])) < \
                (1e-6 if k == "grad_norm" else 2e-5), k
        floor = 1e-6 * float(tm["grad_norm"])
        assert set(grads) <= set(jgrads)
        for name, g in grads.items():
            want = jgrads[name].numpy()
            rel = float(np.linalg.norm(g.numpy() - want)
                        / max(np.linalg.norm(want), floor))
            assert rel < 1e-4, (name, rel)
        got_stats = {k: v.numpy() for k, v in ts.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
        for k, v in jgrads.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_stats[k], v.numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
    assert ts.histogram.shape == (8,)
    assert ts.step == int(js.step) == 1

