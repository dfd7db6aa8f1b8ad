"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, once sound and once for each fault the cell
can have. Serving: an answer altered where it is produced (a final pose;
the hypotheses of one solve in ten); half of the batch left out.
Training: a step that leaves the state unchanged; half of the batch
left out, the mean taken over the rest."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import SERVE_TINY, TRAIN_TINY, TinyCell

CPU = torch.device("cpu")


def _serve(config="zebrapose-v2-r34.json", batch=4):
    cell = TinyCell(config, dict(SERVE_TINY, batch=batch))
    # float32 serving keeps the sound tiny run far inside the limits the
    # full-size bf16 cell was given
    cell.config["serve_dtype"] = "float32"
    drv = harness.load_module(harness.BENCH / "drivers" / "serve.py",
                              "serve_driver_t")
    return drv.run(cell, seed=2 ** 31 + 11, seconds=0.5, trace=False,
                   device=CPU, process_start=time.time())


def _train():
    cell = TinyCell("zebrapose-v2-r34.json", TRAIN_TINY)
    cell.config["train"]["bf16_autocast"] = False
    drv = harness.load_module(harness.BENCH / "drivers" / "train.py",
                              "train_driver_t")
    return drv.run(cell, seed=2 ** 31 + 12, seconds=0.5, trace=False,
                   device=CPU, process_start=time.time())


def _failed(judged):
    return {k for k, c in judged.items() if not c["value"] <= c["limit"]}


def test_sound_serving_run_is_correct():
    result, judged = _serve()
    assert result["correct"], judged
    assert result["attempted"] >= 8 and result["attempted"] % 4 == 0
    assert 0 < result["solved_share"] <= 1


def _patch_decode(monkeypatch, alter):
    from zebrapose_tpu_torch.eval import evaluate

    orig = evaluate.decode_to_pose_batch

    def broken(*args, **kw):
        return alter(*orig(*args, **kw))

    monkeypatch.setattr(evaluate, "decode_to_pose_batch", broken)


def test_an_answer_altered_is_caught(monkeypatch):
    def alter(R, t, ok, n):
        t = t.clone()
        t[0] += 100.0
        return R, t, ok, n

    _patch_decode(monkeypatch, alter)
    result, judged = _serve()
    assert not result["correct"]
    assert "final_trans_max_mm" in _failed(judged)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    def alter(R, t, ok, n):
        half = R.shape[0] // 2
        R, t, ok, n = R.clone(), t.clone(), ok.clone(), n.clone()
        R[half:] = torch.eye(3)
        t[half:] = 0
        ok[half:] = False
        n[half:] = 0
        return R, t, ok, n

    _patch_decode(monkeypatch, alter)
    result, judged = _serve()
    assert not result["correct"]
    assert _failed(judged) & {"final_mismatch", "final_rot_max_deg",
                              "final_trans_max_mm"}


def test_hypotheses_wrong_on_a_minority_of_solves_are_caught(monkeypatch):
    # one solve in ten returns a pose 20 degrees and 40 mm off: the final
    # stage scores the program's own hypotheses on both sides, so only
    # the share of hypotheses astray from float64 can see it
    from zebrapose_tpu_torch.ops import pnp_kernel

    orig = pnp_kernel.minimal_epnp_hypotheses
    c, s_ = torch.cos(torch.tensor(0.35)), torch.sin(torch.tensor(0.35))
    turn = torch.tensor([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])

    def broken(*args, **kw):
        Rs, ts = orig(*args, **kw)
        Rs, ts = Rs.clone(), ts.clone()
        Rs[::10] = turn.to(Rs) @ Rs[::10]
        ts[::10] += 40.0
        return Rs, ts

    broken.launches = orig.launches
    monkeypatch.setattr(pnp_kernel, "minimal_epnp_hypotheses", broken)
    result, judged = _serve()
    assert not result["correct"]
    assert {"hyp_rot_far_excess", "hyp_trans_far_excess"} & \
        _failed(judged), judged


def test_sound_training_run_is_correct():
    result, judged = _train()
    assert result["correct"], judged
    assert result["attempted"] >= TRAIN_TINY["batch"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from zebrapose_tpu_torch.train import train_step as ts

    def no_update(state, accum_steps):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return torch.zeros(())

    monkeypatch.setattr(ts, "apply_accumulated", no_update)
    result, judged = _train()
    assert not result["correct"]
    assert judged["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_training_batch_left_out_is_caught(monkeypatch):
    from zebrapose_tpu_torch.train import train_step as ts

    orig = ts.train_step

    def half(state, batch, *args, **kw):
        n = batch["image"].shape[0] // 2
        return orig(state, {k: v[:n] for k, v in batch.items()}, *args, **kw)

    monkeypatch.setattr(ts, "train_step", half)
    result, judged = _train()
    assert not result["correct"]
    assert "logit_rel_1" in _failed(judged)
