"""The port's fleet across ranks on the CPU: ghost rows
(`train/fleet.py::stack_states(pad_to=)`) against the JAX package's, a
K = 3 fleet over two gloo ranks (padded to 4) against the one-process
fleet member for member, and `run_test_fleet` / `run_vivo_fleet` over two
ranks against one process (tests/torch_world.py spawns the ranks).

Tolerances and why:
  * stack_states(pad_to=) and a fleet step with its ghost row against
    JAX's (a two-layer conv + BatchNorm model in float64 in both stacks,
    as tests/test_torch_fleet.py's JAX test): stacked weights and BN
    statistics within 1e-7 (the port's float32 module takes the carried
    float64 values rounded before `.double()`); after the step, losses
    within 1e-6 relative, weights within 1e-7, BN statistics within
    1e-6; in the port the ghost row equals the last member bit for bit.
  * a member across ranks against the same member in one process, with
    the augmentation injected per member (tests/torch_world.py): bit
    for bit. Each member's forward, backward and Adam update are the
    same operations on the same rows in one thread; only the rows it
    shares a rank with change. The same for the poses of the fleet's
    evaluation: RANSAC draws follow the member's fleet index, so the
    CSVs are byte-equal.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
import torch_world
from test_torch_fleet import _carry, _JTiny, _TTiny
from test_torch_fleet_serve import PNP, fleet_tree  # noqa: F401  (fixture)
from test_torch_train import _batch, _rel
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from zebrapose_tpu.eval import fleet_serve as jfs
from zebrapose_tpu.models.losses import CodeLossConfig as JLossCfg
from zebrapose_tpu.train import fleet as jfleet
from zebrapose_tpu.train import state as jstate
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.eval import fleet_serve as tfs
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.parallel.mesh import World
from zebrapose_tpu_torch.train import fleet
from zebrapose_tpu_torch.train.state import create_train_state

LR = 2e-4
NAMES = ("ape", "cat", "duck")


@pytest.fixture(autouse=True)
def _delete_tmp(tmp_path):
    """Checkpoints with Adam's state are ~0.3 GB each: a test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _ranks(tmp, n):
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def test_ghost_rows_match_jax():
    """Three members padded to four: the stacked state (the ghost row a
    copy of the last member) equals JAX's stack_states(pad_to=4), and
    after a fleet step on a batch whose ghost rows repeat the last
    member's, every row matches JAX's and the port's ghost row is the
    last member bit for bit, with tensors of its own."""
    cfg_j, cfg_t = JLossCfg(), CodeLossConfig()
    batches = [_batch(s, img=32, out=16) for s in (6, 7, 8)]
    batches.append(batches[-1])
    cat = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    with jax.enable_x64(True):
        model = _JTiny(dtype=jnp.float64)
        jstates, tstates = [], []
        for seed in (0, 1, 2):
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
        js = jfleet.stack_states(jstates, pad_to=4)
        ts = fleet.stack_states(tstates, pad_to=4)
        assert len(ts.members) == 4 and ts.best_score == [0.0] * 4
        for i in range(4):
            want = _carry(jax.tree.map(lambda x: x[i], {
                "params": js.params, "batch_stats": js.batch_stats}))
            for k, v in fleet.index_state(ts, i).model.state_dict().items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           atol=1e-7, rtol=0,
                                           err_msg=f"{i} {k}")
        # the ghost's module is its own: its views are of row 3
        ghost, last = ts.members[3], ts.members[2]
        assert ghost is not last
        assert ghost.c1.weight.data_ptr() != last.c1.weight.data_ptr()
        jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), cat)
        tb = {k: torch.from_numpy(v).double() for k, v in cat.items()}
        js, jm = jfleet.fleet_train_step(js, jb, n_models=4, loss_cfg=cfg_j)
        tm = fleet.fleet_train_step(ts, tb, cfg_t)
        for k in jm:
            assert _rel(tm[k].numpy(), np.asarray(jm[k])) < 1e-6, k
            assert tm[k][3] == tm[k][2], k
        for i in range(4):
            want = _carry(jax.tree.map(lambda x: x[i], {
                "params": js.params, "batch_stats": js.batch_stats}))
            got = fleet.index_state(ts, i).model.state_dict()
            for k, v in got.items():
                if k.endswith("num_batches_tracked"):
                    continue
                np.testing.assert_allclose(
                    v.numpy(), want[k].numpy(), rtol=0, err_msg=k,
                    atol=1e-7 if "running" not in k else 1e-6)
        for n in ts.params:
            assert torch.equal(ts.params[n][3], ts.params[n][2]), n
        for n in ts.buffers:
            assert torch.equal(ts.buffers[n][3], ts.buffers[n][2]), n
        assert torch.equal(ts.histogram[3], ts.histogram[2])
        for p in ts.params.values():
            st = ts.optimizer.state[p]
            assert torch.equal(st["exp_avg"][3], st["exp_avg"][2])


def test_member_rows_split_the_padded_fleet():
    rows = [[list(fleet.member_rows(k, World(rank=r, size=w)))
             for r in range(w)] for k, w in ((3, 2), (5, 4), (4, 2),
                                             (3, 1))]
    assert rows == [[[0, 1], [2, 3]], [[0, 1], [2, 3], [4, 5], [6, 7]],
                    [[0, 1], [2, 3]], [[0, 1, 2]]]


def _train_cfg(tree):
    return dict(tree["cfg"], training_data_folder="train_real",
                val_folder="test", BoundingBox_CropSize_image=32,
                BoundingBox_CropSize_GT=16, batch_size=2, num_workers=0)


def test_fleet_over_two_ranks_equals_one_process(fleet_tree, tmp_path):
    """train-fleet's K = 3 members (ape, cat, duck) over two ranks: the
    fleet pads to 4, rank 0 owns ape and cat, rank 1 duck and a ghost row
    built from duck's data. After 3 steps (injected augmentation) and a
    pose validation each real member equals the one-process fleet's
    member bit for bit, the ghost row mirrors duck, every rank returns
    the three bests, and each member's checkpoint and log come from its
    owner alone."""
    cfgd, steps = _train_cfg(fleet_tree), 3
    one = tmp_path / "one"
    torch_world.spawn(torch_world.fleet_fit, 1, one, str(one), cfgd, NAMES,
                      str(one / "out"), steps, False)
    (ref,) = _ranks(one, 1)
    assert ref["n_pad"] == 0 and ref["members"] == list(NAMES)
    two = tmp_path / "two"
    torch_world.spawn(torch_world.fleet_fit, 2, two, str(two), cfgd, NAMES,
                      str(two / "out"), steps)
    r0, r1 = _ranks(two, 2)
    assert (r0["members"], r1["members"]) == (["ape", "cat"], ["duck"])
    assert (r0["first"], r1["first"], r0["n_pad"]) == (0, 2, 1)
    assert r0["ghost_source"] is r1["ghost_source"] is None
    assert r0["rows"] + r1["rows"][:1] == ref["rows"]
    assert r1["rows"][1] == r1["rows"][0]           # the ghost row
    assert r0["best"] == r1["best"] == ref["best"] and len(ref["best"]) == 3
    for n in NAMES:
        run = two / "out" / n
        assert os.listdir(run / "checkpoints" / "steps") == \
            [f"step_{steps}.pth"]
        rows = (run / "logs" / "metrics.jsonl").read_text().splitlines()
        assert sum('"train/loss_total"' in r for r in rows) == 1, n


def test_ghost_only_rank_trains_on_the_last_members_data(fleet_tree,
                                                         tmp_path):
    """K = 1 over two ranks: rank 1 holds only a ghost row, built from
    the member's data without writing anything, and it mirrors rank 0's
    member."""
    cfgd = _train_cfg(fleet_tree)
    torch_world.spawn(torch_world.fleet_fit, 2, tmp_path, str(tmp_path),
                      cfgd, ("ape",), str(tmp_path / "out"), 2, False)
    r0, r1 = _ranks(tmp_path, 2)
    assert (r0["members"], r1["members"]) == (["ape"], [])
    assert r1["ghost_source"] == "ape" and r0["n_pad"] == 1
    assert r1["rows"] == r0["rows"] and r0["best"] == r1["best"]
    rows = (tmp_path / "out" / "ape" / "logs" / "metrics.jsonl") \
        .read_text().splitlines()
    assert sum('"train/loss_total"' in r for r in rows) == 1


def test_fleet_eval_over_two_ranks_equals_one_process(fleet_tree,
                                                      tmp_path):
    """run_test_fleet (ape, cat) and run_vivo_fleet (ape, cat and the
    undetected duck) over two ranks with oracle networks: every rank
    returns the one-process result, and rank 0's per-object and merged
    CSVs are byte-equal to one process's (the RANSAC draws follow the
    member's fleet index). K % W != 0 is refused, as JAX refuses a fleet
    its mesh does not divide."""
    ckpts = {}
    for n in NAMES:
        ckpts[n] = str(tmp_path / f"{n}.oracle")
        torch.save({k: torch.from_numpy(v) for k, v in
                    fleet_tree["oracles"][n].items()}, ckpts[n])
    cfgd = fleet_tree["cfg"]
    args = (cfgd, ("ape", "cat"), NAMES, ckpts)
    for w in (1, 2):
        d = tmp_path / f"w{w}"
        torch_world.spawn(torch_world.fleet_eval, w, d, str(d), *args,
                          str(d / "out"), PNP)
    (ref,), got = _ranks(tmp_path / "w1", 1), _ranks(tmp_path / "w2", 2)
    assert got[0] == got[1] == {
        k: {**v, "merged_csv": v["merged_csv"].replace("/w1/", "/w2/")}
        for k, v in ref.items()}
    assert ref["test"]["per_object"]["ape"]["ADD_recall_0.1d"] == 1.0
    assert ref["vivo"]["per_object"]["duck"]["instances"] == 0
    for cmd, csvs in (("test", ["lmo_ape.csv", "lmo_cat.csv",
                                "../lmo_fleet.csv"]),
                      ("vivo", ["lmo_ape.csv", "lmo_cat.csv",
                                "../lmo_vivo_fleet.csv"])):
        for c in csvs:
            a, b = (tmp_path / f"w{w}" / "out" / cmd / "pose_result_bop" / c
                    for w in (1, 2))
            assert a.read_bytes() == b.read_bytes(), (cmd, c)
    cfg = ZebraConfig.from_dict(cfgd)
    for fn, names, w in ((tfs.run_test_fleet, NAMES, 2),
                         (tfs.run_vivo_fleet, NAMES, 3)):
        with pytest.raises(ValueError, match="not divisible by world size"):
            fn(cfg, list(names), [ckpts[n] for n in names],
               str(tmp_path / "refused"), world=World(rank=0, size=w))
    assert "not divisible by mesh size" in open(jfs.__file__).read()
