"""The port's data-parallel training (`parallel/mesh.py`) on the CPU:
two gloo ranks, spawned with a `file://` rendezvous (tests/torch_world.py),
against the JAX package's train step on a 2-device CPU mesh
(tests/conftest.py gives 8 virtual devices), the global histogram, the
replicas' bit identity, the world arithmetic and each rank's draws
against JAX's, and `train --multihost` under two ranks.

Tolerances and why:
  * two ranks' step vs JAX's 2-device `train_step` / `accum_train_step`
    (ZebraPoseNet v2 at 32², 4 rows of a global micro-batch, float64
    network in both stacks, as tests/test_torch_train.py's float64 step
    test and for its reason): each gradient tensor within 1e-4 relative
    L2, the metrics within 1e-4 relative, the BN running statistics
    within 1e-5, the histogram within 1e-6 (the same pixels counted in
    float64 activations).
  * the histogram of two ranks vs one process on the whole batch: within
    1e-7 (float32 sums of the same {0, 1} values in another order are
    exact up to 2^24; the division differs by one rounding at most).
  * the ranks against each other: bit for bit (they apply one
    all-reduced gradient to one state).
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
import torch_world
from test_torch_model import flax_variables
from test_torch_train import LR, _batch, _grads_in_port_names, _rel
from test_torch_trainer import (  # noqa: F401  (fixtures)
    _datasets,
    _equal,
    _hide_module_stubs,
    _write_cfg,
    tree,
)
from zebrapose_tpu.data import pipeline as jpipe
from zebrapose_tpu.models import losses as jlosses
from zebrapose_tpu.models.losses import CodeLossConfig as JLossCfg
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.parallel import mesh as jmesh
from zebrapose_tpu.train import state as jstate
from zebrapose_tpu.train import train_step as jts
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data.pipeline import (
    CachedBatchIterator,
    DeviceDatasetCache,
    MixedBatchIterator,
)
from zebrapose_tpu_torch.eval.runner import load_model
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.losses import CodeLossConfig, total_loss
from zebrapose_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STATE_FIELDS = ("step", "params", "batch_stats", "opt_state", "histogram",
                 "best_score")


@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """The ranks' records (a float64 gradient is ~0.23 GB) and a
    checkpoint with Adam's state (~0.35 GB) go when a test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _ranks(tmp, n=2):
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _jax_world_step(variables, micro):
    """JAX's train_step (one micro-batch) or accum_train_step on a
    2-device mesh, float64; (state, metrics)."""
    with jax.enable_x64(True):
        js = jstate.create_train_state(
            JNet(binary_code_length=16, variant="v2", dtype=jnp.float64),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
            learning_rate=LR, n_bits=16)
        m = jmesh.make_mesh(jax.devices()[:2])
        js = js.replace(**{f: jmesh.replicate(m, getattr(js, f))
                           for f in _STATE_FIELDS})
        feeds = [jmesh.shard_batch(m, {k: v.astype(np.float64)
                                       for k, v in b.items()})
                 for b in micro]
        if len(feeds) == 1:
            js, jm = jts.train_step(js, feeds[0], JLossCfg())
        else:
            js, jm = jts.accum_train_step(js, iter(feeds), JLossCfg())
        return js, {k: float(v) for k, v in jm.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_match_jax_world_step_in_float64(tmp_path, accum):
    """One optimizer step of two ranks (2 rows each of every global
    micro-batch of 4) against JAX's step over the 4 rows on a 2-device
    mesh: `train_step`, and with accum = 2 `accum_train_step` (the
    gradient all-reduced once, at the update). The gradient of the
    global mean loss, global BatchNorm statistics, the global
    histogram, metrics averaged over the ranks; both ranks bit-equal."""
    variables = flax_variables("v2", np.random.default_rng(2))
    micro = [_batch(3 + i, n=4) for i in range(accum)]
    torch.save({"sd": variables_to_state_dict(variables), "micro": micro,
                "lr": LR}, tmp_path / "inputs.pt")
    torch_world.spawn(torch_world.step_f64, 2, tmp_path, str(tmp_path))
    r0, r1 = _ranks(tmp_path)
    assert r0["digests"] == r1["digests"]
    assert r0["metrics"] == r1["metrics"] and r0["step"] == 1
    js, jm = _jax_world_step(variables, micro)
    assert sorted(r0["metrics"]) == sorted(jm)
    for k in jm:
        assert _rel(r0["metrics"][k], jm[k]) < 1e-4, k
    jgrads = _grads_in_port_names(js)
    floor = 1e-6 * r0["metrics"]["grad_norm"]
    assert set(r0["grads"]) <= set(jgrads)
    for name, g in r0["grads"].items():
        want = jgrads[name].numpy()
        rel = float(np.linalg.norm(g.numpy() - want)
                    / max(np.linalg.norm(want), floor))
        assert rel < 1e-4, (name, rel)
    for k, v in r0["stats"].items():
        np.testing.assert_allclose(v.numpy(), jgrads[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(r0["histogram"].numpy(),
                               np.asarray(js.histogram), atol=1e-6)


def test_histogram_is_the_global_batchs(tmp_path):
    """The ranks' halves have very different predicted mask sizes (rank
    0's rows almost all foreground, rank 1's a few pixels): under
    global_batch the two ranks' histogram is the one of the whole batch
    in one process (and JAX's hamming_histogram on it), where the mean
    of the ranks' own histograms is far from it."""
    rng = np.random.default_rng(11)
    n, h, bits = 4, 16, 16
    mask = np.where(np.arange(n)[:, None, None, None] < 2,
                    rng.normal(2.0, 1.0, (n, h, h, 1)),
                    rng.normal(-2.5, 1.0, (n, h, h, 1))).astype(np.float32)
    outputs = {"mask": torch.from_numpy(mask),
               "entire_mask": torch.from_numpy(mask),
               "code": torch.from_numpy(
                   rng.normal(0, 2, (n, h, h, bits)).astype(np.float32))}
    gt = {"mask": torch.from_numpy((mask[..., 0] > 0).astype(np.float32)),
          "entire_mask": torch.ones(n, h, h),
          "code": torch.from_numpy(
              (rng.random((n, h, h, bits)) > 0.5).astype(np.float32))}
    hist0 = torch.linspace(0.05, 0.45, bits)
    torch.save({"outputs": outputs, "gt": gt, "histogram": hist0},
               tmp_path / "outputs.pt")
    torch_world.spawn(torch_world.global_histogram, 2, tmp_path,
                      str(tmp_path))
    r0, r1 = _ranks(tmp_path)
    _, whole, metrics = total_loss(outputs, gt["mask"], gt["entire_mask"],
                                   gt["code"], hist0, CodeLossConfig())
    for r in (r0, r1):
        np.testing.assert_allclose(r["global"]["histogram"].numpy(),
                                   whole.numpy(), atol=1e-7, rtol=0)
        assert abs(r["global"]["hamming"] - float(metrics["hamming"])) \
            < 1e-7
    assert torch.equal(r0["global"]["histogram"], r1["global"]["histogram"])
    jhamm, jhist = jlosses.hamming_histogram(
        jnp.asarray(outputs["code"].numpy()), jnp.asarray(gt["code"].numpy()),
        jnp.asarray((mask > 0).astype(np.float32)))
    ema = 0.95 * hist0.numpy() + 0.05 * np.asarray(jhist)
    np.testing.assert_allclose(r0["global"]["histogram"].numpy(), ema,
                               atol=1e-6)
    # the finding: the mean of the ranks' own EMAs misses it
    mean = (r0["local"]["histogram"] + r1["local"]["histogram"]) / 2
    assert float((mean - whole).abs().max()) > 1e-3


def test_replicas_stay_bit_identical(tmp_path):
    """Ranks that initialise different weights start from rank 0's after
    `replicate` and, after three steps, carry bit-identical weights, BN
    statistics, histogram and Adam moments (the checks of
    __graft_entry__.py's multi-chip dry run); a resume whose ranks stand
    at different steps is refused on every rank."""
    torch.save({"lr": LR, "batches": [_batch(20 + i, n=4)
                                      for i in range(3)]},
               tmp_path / "inputs.pt")
    torch_world.spawn(torch_world.replicas, 2, tmp_path, str(tmp_path))
    r0, r1 = _ranks(tmp_path)
    assert r0["own"] != r1["own"]          # different inits
    assert r1["start"] == r0["start"] == r0["own"]
    assert r0["end"] == r1["end"] and r0["step"] == r1["step"] == 3
    assert any(k.startswith("adam/") for k in r0["end"])
    assert r0["losses"] == r1["losses"] and np.isfinite(r0["losses"]).all()
    assert r0["refused"] and r1["refused"]


def test_world_arithmetic_matches_jax_with_two_processes():
    assert mesh.scale_for_world(2e-4, 380_000, 2) == \
        jmesh.scale_for_world(2e-4, 380_000, 2)
    for g in (2, 32, 64):
        assert mesh.local_batch_size(g, 2) == \
            jmesh.local_batch_size(g, n_processes=2)
    for args in ((32, 1, 2), (32, 2, 2), (32, 4, 2), (64, 8, 2),
                 (32, 2, 4), (64, 2, 8)):
        assert mesh.validate_batch_partition(*args, n_processes=2) == \
            jmesh.validate_batch_partition(*args, n_processes=2), args
    for args in ((31, 1, 2), (32, 32, 2), (32, 0, 2), (24, 4, 4)):
        with pytest.raises(ValueError) as want:
            jmesh.validate_batch_partition(*args, n_processes=2)
        with pytest.raises(ValueError) as got:
            mesh.validate_batch_partition(*args, n_processes=2)
        assert str(got.value) == str(want.value), args
    with pytest.raises(ValueError) as want:
        jmesh.local_batch_size(33, n_processes=2)
    with pytest.raises(ValueError) as got:
        mesh.local_batch_size(33, 2)
    assert str(got.value) == str(want.value)
    # a rank's rows of a global batch
    batch = {"x": np.arange(8)}
    assert mesh.shard_batch(mesh.World(rank=1, size=2), batch)["x"] \
        .tolist() == [4, 5, 6, 7]


@pytest.mark.parametrize("rank", [0, 1])
def test_each_ranks_iterators_draw_as_jax_with_seed_rank(tree, rank):
    """A rank's MixedBatchIterator and CachedBatchIterator at seed =
    rank, at the per-rank batch, are JAX's (`seed=jax.process_index()`)
    byte for byte."""
    (j1, t1), (j2, t2) = (_datasets(tree[0]),
                          _datasets(tree[0], "train_second"))
    ji = jpipe.MixedBatchIterator(j1, j2, batch_size=2,
                                  second_dataset_ratio=0.5, seed=rank,
                                  num_workers=0)
    ti = MixedBatchIterator(t1, t2, batch_size=2, second_dataset_ratio=0.5,
                            seed=rank, num_workers=0)
    try:
        for _ in range(2):
            _equal(next(ti), next(ji))
    finally:
        ji.close()
        ti.close()
    (j1, t1), (j2, t2) = (_datasets(tree[0]),
                          _datasets(tree[0], "train_second"))
    jc = jpipe.CachedBatchIterator(jpipe.DeviceDatasetCache([j1, j2]),
                                   batch_size=2, second_dataset_ratio=0.5,
                                   seed=rank)
    tc = CachedBatchIterator(DeviceDatasetCache([t1, t2], "cpu"),
                             batch_size=2, second_dataset_ratio=0.5,
                             seed=rank)
    for _ in range(3):
        got, want = next(tc), next(jc)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_train_setup_over_two_ranks(tree, tmp_path):
    """build_train_setup over two ranks (batch_size 4: 2 rows a rank):
    lr × 2, iterations ÷ 2, each rank's stream and device-cache draws
    equal to JAX's iterators at seed = rank, one writer (rank 0), and
    every rank at rank 0's state."""
    cfgd = dict(tree[1], predict_entire_mask=True)
    torch_world.spawn(torch_world.train_setup_draws, 2, tmp_path,
                      str(tmp_path), cfgd, str(tmp_path / "out"))
    ranks = _ranks(tmp_path)
    for mode in ("stream", "device_cache"):
        assert ranks[0][mode]["digests"] == ranks[1][mode]["digests"]
        assert [r[mode]["writes"] for r in ranks] == [True, False]
    for rank, got in enumerate(ranks):
        for mode in ("stream", "device_cache"):
            assert got[mode]["lr"] == 2 * ZebraConfig.from_dict(
                cfgd).learning_rate
            assert got[mode]["iters"] == 1000 // 2
        ji = jpipe.MixedBatchIterator(_datasets(tree[0])[0], None,
                                      batch_size=2, seed=rank,
                                      num_workers=0)
        try:
            for draw in got["stream"]["draws"]:
                _equal(draw, next(ji))
        finally:
            ji.close()
        jc = jpipe.CachedBatchIterator(jpipe.DeviceDatasetCache(
            [_datasets(tree[0])[0]]), batch_size=2, seed=rank)
        for draw in got["device_cache"]["draws"]:
            want = next(jc)
            for k in want:
                np.testing.assert_array_equal(draw[k], want[k], err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_train_multihost_under_two_ranks(tree, tmp_path):
    """`python -m zebrapose_tpu_torch train --multihost --device cpu`
    in two processes joined over tcp://localhost (the environment
    torchrun gives its workers), 2 steps with a pose validation: one
    checkpoint directory and one log, written by rank 0, rank 0 alone
    prints, and its checkpoint loads into `test`'s model."""
    cfg = _write_cfg(tree, tmp_path / "cfg.txt")
    out = tmp_path / "runs"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "zebrapose_tpu_torch", "train",
             "--multihost", "--cfg", cfg, "--obj_name", "ape", "--device",
             "cpu", "--from_scratch", "--max_steps", "2", "--log_freq", "2",
             "--output_dir", str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1] + outs[1][1]
    assert "best val recall:" in outs[0][0]
    assert "best val recall:" not in outs[1][0] and "[step" not in outs[1][0]
    run = out / "lmo_ape"
    assert sorted(os.listdir(run / "checkpoints" / "steps")) == \
        ["step_2.pth"]
    rows = [json.loads(ln) for ln in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if r["tag"] == "train/loss_total"] == [2]
    assert {"val/ADD_recall_0.1d", "timing/fit_s"} <= {r["tag"]
                                                       for r in rows}
    load_model(ZebraConfig.from_file(cfg),
               str(run / "checkpoints" / "steps" / "step_2.pth"),
               device="cpu")
