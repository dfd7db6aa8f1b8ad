"""Train state: the model (parameters and BN statistics), Adam, the step,
the loss-EMA histogram and the best validation score.

Port of `zebrapose_tpu/train/state.py`. Everything the reference keeps
in its checkpoint dicts (`zebrapose/utils_v2.py`) lives in one object,
and the bit-error histogram (module state in the reference,
BinaryCodeNet.py:32) is part of it, so it is saved and restored.
`world` is the data-parallel world the state trains in
(`parallel/mesh.py`; None or size 1: one process); its model's
BatchNorm layers hold it too.
Adam has optax's constants, which are torch's defaults (b1 0.9, b2
0.999, eps 1e-8 added outside the square root, no weight decay).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from zebrapose_tpu_torch.models.layers import TorchBatchNorm
from zebrapose_tpu_torch.models.losses import fresh_histogram
from zebrapose_tpu_torch.parallel.mesh import World


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    histogram: torch.Tensor = None
    best_score: float = 0.0
    world: Optional[World] = None


def make_lr_schedule(base_lr: float, gamma: float = 1.0,
                     log_freq: int = 1000,
                     scheduler_step_size: int = 10) -> Callable[[int], float]:
    """StepLR as the reference uses it: scheduler.step() once per
    `log_freq` iterations (train_v2.py:333), decay every
    `scheduler_step_size` of those -> lr = base * gamma^(step //
    (log_freq * scheduler_step_size)). optax evaluates it at the count
    of updates before the current one: update k uses lr(k)."""
    period = log_freq * scheduler_step_size

    def schedule(step: int) -> float:
        return base_lr * (gamma ** (step // period))

    return schedule


def create_train_state(model: torch.nn.Module, learning_rate: float,
                       n_bits: int = 16, gamma: float = 1.0,
                       log_freq: int = 1000,
                       world: Optional[World] = None) -> TrainState:
    """State for `model` (already on its device). The optimizer's lr is
    set from the schedule before every update (`train_step`). `world`
    is handed to the model's BatchNorm layers, which then take their
    training statistics over its global batch; with several ranks, call
    `parallel.mesh.replicate` before the first step, so every rank
    starts from rank 0's state."""
    dev = next(model.parameters()).device
    for m in model.modules():
        if isinstance(m, TorchBatchNorm):
            m.world = world
    schedule = make_lr_schedule(learning_rate, gamma, log_freq)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      histogram=fresh_histogram(n_bits, dev), world=world)
