"""Training step: host ms a step issuing the loss stack
(`models/losses.py::total_loss`): the program's `zebrapose.train.loss`
span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.loss")
