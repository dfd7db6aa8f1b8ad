"""The control comes out not correct: `control.readings` at a tiny size
on the CPU (the chip runs it at the cells' own size, three seeds or
more, for the upper readings in PERF.md)."""

from __future__ import annotations

import torch

from benchmark import control
from benchmark.tests.tiny import SERVE_TINY, TRAIN_TINY, TinyCell

CPU = torch.device("cpu")


def _failed(config, nums):
    lim = config["limits"]
    lim = lim["train"] if "update_gap" in nums else lim["serve"]
    return {k for k, v in lim.items() if not nums.get(k, float("nan")) <= v}


def test_serving_control_fails():
    for cfg in ("zebrapose-v2-r34.json", "zebrapose-v2-r34-int8.json"):
        cell = TinyCell(cfg, SERVE_TINY)
        got = {kind: nums for _, _, kind, nums in
               control.readings(cell, [5], 1, CPU)}
        assert set(got) == {"program", "control"}
        # the crop in bfloat16, and the forward one precision lower
        assert {"crop_err"} <= _failed(cell.config, got["control"])
        logit = "logit_rel" if "int8" in cfg else "logit_rel_entire_mask"
        assert got["control"][logit] > 2 * got["program"][logit]


def test_training_control_and_fault_fail():
    from benchmark import checks

    cell = TinyCell("zebrapose-v2-r34.json", TRAIN_TINY)
    cell.config["train"]["bf16_autocast"] = False
    got = {kind: nums for _, _, kind, nums in
           control.readings(cell, [6], 1, CPU)}
    assert set(got) == {"program", "control", "fault_half"}
    lim = cell.config["limits"]["train"]
    assert checks.passed(checks.judge(got["program"], lim))
    # the reference's steps on fp8 operands in the program's place
    assert not checks.passed(checks.judge(got["control"], lim))
    assert "logit_rel_1" in _failed(cell.config, got["control"])
    assert "logit_rel_1" in _failed(cell.config, got["fault_half"])
