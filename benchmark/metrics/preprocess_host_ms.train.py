"""Training input: host ms a step issuing the gather, crop, augmentation
and code planes in `gather_preprocess_batch`: the program's
`zebrapose.train.preprocess` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.preprocess")
