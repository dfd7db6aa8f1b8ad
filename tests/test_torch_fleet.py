"""The port's fleet trainer (`train/fleet.py`) on the CPU: the
fleet step against K single `train_step`s of the port and against the
JAX package's `fleet_train_step`, the stack / index round trip,
`fit_fleet`'s cadence (per-member logs, rolling and best checkpoints
that `test` loads), an exact resume and the refusal of mixed steps.

Tolerances and why:
  * fleet step vs K single steps (ZebraPoseNet v2 at 32², b2 a member,
    float64 network): each member's forward and backward is
    the single one; what differs is the order of float operations in
    Adam over the stacked tensors and in grad_norm. Weights and BN
    statistics within 1e-8 (Adam's normalized step takes a near-zero
    gradient element to ~lr = 2e-4, so rounding there can show at
    ~1e-9), the metrics within 1e-6 relative (they are float32 in both:
    total_loss computes in float32, grad_norm is a float32 norm),
    histograms within 1e-6, Adam's moments within 1e-7 of each tensor's
    largest.
  * fleet step vs JAX's fleet_train_step: a two-member convolution +
    BatchNorm + ReLU + convolution model (ZebraPoseNet's layers, small
    enough for JAX's vmapped step to compile in seconds) in float64 in
    both stacks, weights carried; two steps: losses and grad_norm within
    1e-6 relative, parameters within 1e-7 absolute, BN statistics within
    1e-6, histograms within 1e-6, as the float64 train-step test of
    tests/test_torch_train.py.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from test_torch_train import _batch, _rel, _t
from test_torch_trainer import (  # noqa: F401  (fixtures)
    _Repeat,
    _datasets,
    _hide_module_stubs,
    _resources,
    _rows,
    tree,
)
from zebrapose_tpu.models import layers as jlayers
from zebrapose_tpu.models.losses import CodeLossConfig as JLossCfg
from zebrapose_tpu.train import fleet as jfleet
from zebrapose_tpu.train import state as jstate
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval.runner import load_model
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.layers import TorchBatchNorm, TorchConv
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.train import fleet
from zebrapose_tpu_torch.train import train_step as tts
from zebrapose_tpu_torch.train.checkpoints import CheckpointManager
from zebrapose_tpu_torch.train.state import create_train_state

LR = 2e-4


@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints with Adam's state are ~0.3 GB each: a test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _net_state(seed):
    model = ZebraPoseNet(binary_code_length=16, variant="v2")
    model.load_state_dict(variables_to_state_dict(flax_variables(
        "v2", np.random.default_rng(seed))), strict=True)
    model.double()
    return create_train_state(model, LR, n_bits=16)


def _sd(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_fleet_step_matches_single_steps():
    """Two members with their own weights and batches: a fleet step =
    a train_step of each member (losses, grad_norm, parameters, BN
    statistics, histograms, Adam's moments)."""
    cfg = CodeLossConfig()
    singles = [_net_state(s) for s in (2, 3)]
    fs = fleet.stack_states([copy.deepcopy(s) for s in singles])
    batches = [{k: v.double() for k, v in _t(_batch(s)).items()}
               for s in (4, 5)]
    cat = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
    fm = fleet.fleet_train_step(fs, cat, cfg)
    ms = [tts.train_step(s, b, cfg) for s, b in zip(singles, batches)]
    assert sorted(fm) == sorted(ms[0])
    for i, m in enumerate(ms):
        for k in m:
            assert _rel(fm[k][i].item(), m[k].item()) < 1e-6, (i, k)
    assert fs.step == 1
    for i, s in enumerate(singles):
        got = fleet.index_state(fs, i)
        assert got.step == s.step == 1
        want = _sd(s.model)
        for k, v in _sd(got.model).items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=1e-8, rtol=0, err_msg=k)
        np.testing.assert_allclose(got.histogram.numpy(),
                                   s.histogram.numpy(), atol=1e-6)
        po = dict(s.model.named_parameters())
        pg = dict(got.model.named_parameters())
        for n in ("net.resnet.resnet.0.weight", "net.aspp.conv_1x1_4.bias"):
            for key in ("exp_avg", "exp_avg_sq"):
                want = s.optimizer.state[po[n]][key].numpy()
                np.testing.assert_allclose(
                    got.optimizer.state[pg[n]][key].numpy(), want,
                    rtol=0, atol=1e-7 * np.abs(want).max(),
                    err_msg=(n, key))
    # the members stayed apart
    assert not torch.equal(fs.params["net.aspp.conv_1x1_4.weight"][0],
                           fs.params["net.aspp.conv_1x1_4.weight"][1])


class _JTiny(fnn.Module):
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        kw = dict(dtype=self.dtype, param_dtype=self.dtype)
        y = fnn.Conv(8, (3, 3), strides=2, padding=1, use_bias=False,
                     **kw)(x)
        y = fnn.relu(jlayers.TorchBatchNorm(dtype=self.dtype)(y, train))
        out = fnn.Conv(18, (1, 1), **kw)(y)
        return {"mask": out[..., :1], "entire_mask": out[..., 1:2],
                "code": out[..., 2:]}


class _TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = TorchConv(3, 8, 3, 2, 1, use_bias=False)
        self.bn = TorchBatchNorm(8)
        self.c2 = TorchConv(8, 18, 1)

    def forward(self, x):
        y = self.c2(torch.relu(self.bn(self.c1(x.permute(0, 3, 1, 2)))))
        y = y.permute(0, 2, 3, 1)
        return {"mask": y[..., :1], "entire_mask": y[..., 1:2],
                "code": y[..., 2:]}


def _carry(v):
    """flax _JTiny variables -> a _TTiny state dict."""
    p, s = v["params"], v["batch_stats"]["TorchBatchNorm_0"]["bn"]
    hwio = lambda k: torch.from_numpy(  # noqa: E731
        np.asarray(k).transpose(3, 2, 0, 1).copy())
    return {"c1.weight": hwio(p["Conv_0"]["kernel"]),
            "bn.weight": torch.from_numpy(np.asarray(
                p["TorchBatchNorm_0"]["bn"]["scale"])),
            "bn.bias": torch.from_numpy(np.asarray(
                p["TorchBatchNorm_0"]["bn"]["bias"])),
            "bn.running_mean": torch.from_numpy(np.asarray(s["mean"])),
            "bn.running_var": torch.from_numpy(np.asarray(s["var"])),
            "bn.num_batches_tracked": torch.tensor(0),
            "c2.weight": hwio(p["Conv_1"]["kernel"]),
            "c2.bias": torch.from_numpy(np.asarray(p["Conv_1"]["bias"]))}


def test_fleet_step_matches_jax_in_float64():
    cfg_j, cfg_t = JLossCfg(), CodeLossConfig()
    batches = [_batch(s, img=32, out=16) for s in (6, 7)]
    cat = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    with jax.enable_x64(True):
        model = _JTiny(dtype=jnp.float64)
        jstates, tstates = [], []
        for seed in (0, 1):
            v = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 32, 32, 3), jnp.float64))
            rng = np.random.default_rng(seed)
            v = {"params": v["params"], "batch_stats": {
                "TorchBatchNorm_0": {"bn": {
                    "mean": jnp.asarray(rng.normal(0, 0.1, 8)),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, 8))}}}}
            jstates.append(jstate.create_train_state(
                model, v, learning_rate=LR, n_bits=16))
            tm = _TTiny()
            tm.load_state_dict(_carry(v), strict=True)
            tstates.append(create_train_state(tm.double(), LR, n_bits=16))
        js = jfleet.stack_states(jstates)
        ts = fleet.stack_states(tstates)
        jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), cat)
        tb = {k: torch.from_numpy(v).double() for k, v in cat.items()}
        for _ in range(2):
            js, jm = jfleet.fleet_train_step(js, jb, n_models=2,
                                             loss_cfg=cfg_j)
            tm = fleet.fleet_train_step(ts, tb, cfg_t)
            assert sorted(tm) == sorted(jm)
            for k in jm:
                assert _rel(tm[k].numpy(), np.asarray(jm[k])) < 1e-6, k
        for i in range(2):
            want = _carry(jax.tree.map(lambda x: x[i], {
                "params": js.params, "batch_stats": js.batch_stats}))
            got = fleet.index_state(ts, i)
            for k, v in got.model.state_dict().items():
                if k.endswith("num_batches_tracked"):
                    assert int(v) == 2
                    continue
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           atol=1e-7 if "running" not in k
                                           else 1e-6, rtol=0, err_msg=k)
            np.testing.assert_allclose(got.histogram.numpy(),
                                       np.asarray(js.histogram)[i],
                                       atol=1e-6)
        assert ts.step == 2 and list(np.asarray(js.step)) == [2, 2]


def test_stack_index_roundtrip():
    """index_state(stack_states(states), i) gives back member i: weights,
    BN statistics, Adam's moments and step, histogram, best score."""
    states = [_net_state(s) for s in (8, 9)]
    b = {k: v.double() for k, v in _t(_batch(10)).items()}
    for s in states:
        tts.train_step(s, b, CodeLossConfig())
    states[1].best_score = 0.25
    fs = fleet.stack_states(states)
    assert fs.params["net.aspp.conv_1x1_4.weight"].shape[0] == 2
    for i, s in enumerate(states):
        got = fleet.index_state(fs, i)
        assert (got.step, got.best_score) == (s.step, s.best_score)
        want = s.model.state_dict()
        for k, v in got.model.state_dict().items():
            assert torch.equal(v, want[k]), k
        assert torch.equal(got.histogram, s.histogram)
        so, go = s.optimizer.state_dict(), got.optimizer.state_dict()
        assert sorted(so["state"]) == sorted(go["state"])
        for j in so["state"]:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(so["state"][j][key],
                                   go["state"][j][key]), (j, key)


def _members(tree, tmp_path, names, seeds, iters=None, val=True):
    return [_resources(tree, str(tmp_path / n), seed=s, val=val,
                       train_iter=None if iters is None else iters[i])
            for i, (n, s) in enumerate(zip(names, seeds))]


def test_fit_fleet_cadence(tree, tmp_path, monkeypatch):
    """Two members, log_freq 3 over 5 steps: each logs its metrics,
    histogram and per-step losses at steps 3 and 5 in its own log, saves
    its own rolling checkpoints (which `test` loads, each with its own
    weights), and after the fleet's pose validation a best checkpoint
    where its recall rose."""
    members = _members(tree, tmp_path, ("ape", "cat"), (4, 5))
    fr = fleet.FleetResources(members, fleet.stack_states(
        [m.state for m in members]))
    recalls = iter([[0.5, 0.0], [0.25, 0.0]])
    real = fleet._fleet_validate

    def spy(*args):
        out = real(*args)
        for m, r in zip(out, next(recalls)):
            m["ADD_recall_0.1d"] = r
        return out

    monkeypatch.setattr(fleet, "_fleet_validate", spy)
    timing = {}
    best = fleet.fit_fleet(fr, log_freq=3, max_steps=5, timing=timing)
    assert best == [0.5, 0.0] and fr.state.best_score == [0.5, 0.0]
    assert timing["steps"] == 5 and timing["val_s"] > 0
    cfg = ZebraConfig.from_dict(tree[1])
    losses = []
    for i, name in enumerate(("ape", "cat")):
        out = str(tmp_path / name)
        rows = _rows(out)
        tags = {r["tag"] for r in rows}
        assert {"train/loss_total", "train/grad_norm", "train/bit_err_15",
                "val/ADD_recall_0.1d", "val/ADD_auc_posecnn"} <= tags
        assert [r["step"] for r in rows
                if r["tag"] == "train/loss_total"] == [3, 5]
        steps = [r for r in rows if r["tag"] == "train/step_loss_total"]
        assert [r["step"] for r in steps] == list(range(1, 6))
        losses.append([r["value"] for r in steps])
        assert np.isfinite(losses[-1]).all()
        assert sorted(os.listdir(os.path.join(out, "ck", "steps"))) == \
            ["step_3.pth", "step_5.pth"]
        m = load_model(cfg, os.path.join(out, "ck", "steps", "step_5.pth"),
                       device="cpu")
        want = fleet.index_state(fr.state, i).model.state_dict()
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k
    assert losses[0] != losses[1]          # two models, not one
    assert sorted(os.listdir(tmp_path / "ape" / "ck" / "best")) == \
        ["best_score.txt", "step_3.pth"]
    assert (tmp_path / "ape" / "ck" / "best" / "best_score.txt") \
        .read_text() == "0.5 step 3\n"
    assert not (tmp_path / "cat" / "ck" / "best").exists()
    payload = torch.load(str(tmp_path / "ape" / "ck" / "best" /
                             "step_3.pth"), weights_only=True)
    assert payload["best_score"] == 0.5 and payload["step"] == 3
    # the rolling checkpoints after it carry the member's best score
    payload = torch.load(str(tmp_path / "ape" / "ck" / "steps" /
                             "step_5.pth"), weights_only=True)
    assert payload["best_score"] == 0.5
    load_model(cfg, str(tmp_path / "ape" / "ck" / "best" / "step_3.pth"),
               device="cpu")


def test_fit_fleet_resume_and_mixed_steps(tree, tmp_path):
    """4 fleet steps = 2 steps, each member restored from its rolling
    checkpoint into a fresh model, and 2 more (weights, BN statistics,
    Adam's moments, histograms, exactly); members at different steps are
    refused."""
    batch = _datasets(tree[0])[1].collate([0, 1, 2, 3])

    def run(names, seeds, steps, log_freq=2, restore=None):
        ms = _members(tree, tmp_path, names, seeds,
                      iters=[_Repeat(batch)] * 2, val=False)
        if restore is not None:
            for m, src in zip(ms, restore):
                CheckpointManager(str(tmp_path / src / "ck")).restore(
                    m.state, step=2)
        fr = fleet.FleetResources(ms, fleet.stack_states(
            [m.state for m in ms]))
        fleet.fit_fleet(fr, log_freq=log_freq, max_steps=steps,
                        validate=False)
        for m in ms:
            m.ckpt.close()
        return fr

    # a checkpoint of this model with Adam's moments is ~0.5 GB, and six
    # workers share the disk: the runs whose files nothing reads delete
    # them at once, so at most four are on disk
    a = run(("a0", "a1"), (4, 5), 4, log_freq=4)
    for n in ("a0", "a1"):
        shutil.rmtree(tmp_path / n)
    run(("b0", "b1"), (4, 5), 2)
    c = run(("c0", "c1"), (6, 7), 2, restore=("b0", "b1"))
    for n in ("b0", "c0", "c1"):
        shutil.rmtree(tmp_path / n)
    assert a.state.step == c.state.step == 4
    for n, p in a.state.params.items():
        assert torch.equal(p, c.state.params[n]), n
    for n, b in a.state.buffers.items():
        assert torch.equal(b, c.state.buffers[n]), n
    assert torch.equal(a.state.histogram, c.state.histogram)
    for n, p in a.state.params.items():
        sa = a.state.optimizer.state[p]
        sc = c.state.optimizer.state[c.state.params[n]]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sc[key]), (n, key)

    ms = _members(tree, tmp_path, ("d0", "d1"), (4, 5),
                  iters=[_Repeat(batch)] * 2, val=False)
    # d1 resumes b1's rolling checkpoint at step 2, d0 starts afresh
    CheckpointManager(str(tmp_path / "b1" / "ck")).restore(ms[1].state,
                                                          step=2)
    assert ms[1].state.step == 2
    with pytest.raises(ValueError, match="different steps"):
        fleet.stack_states([m.state for m in ms])
    for m in ms:
        m.ckpt.close()
