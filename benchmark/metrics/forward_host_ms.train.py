"""Training step: host ms a step issuing the train-mode forward under
autocast: the program's `zebrapose.train.forward` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.forward")
