"""Serving entry: host ms a batch issuing `preprocess_batch` (the crop
and normalization): the program's `zebrapose.serve.preprocess` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.serve.step",
                         "zebrapose.serve.preprocess")
