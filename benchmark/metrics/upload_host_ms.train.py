"""Training input: host ms a step moving the drawn indices, crop
parameters and valid flags to the card in `gather_preprocess_batch`:
the program's `zebrapose.train.upload` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.train.step",
                         "zebrapose.train.upload")
