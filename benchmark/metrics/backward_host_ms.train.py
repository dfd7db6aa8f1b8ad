"""Training step: host ms a step issuing the backward: the program's
`zebrapose.train.backward` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.backward")
