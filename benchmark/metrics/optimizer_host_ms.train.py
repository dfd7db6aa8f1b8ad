"""Training step: host ms a step in `apply_accumulated` (the gradient
norm, the schedule, `Adam.step` and `zero_grad`): the program's
`zebrapose.train.optimizer` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.optimizer")
