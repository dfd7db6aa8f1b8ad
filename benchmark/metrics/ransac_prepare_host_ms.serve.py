"""Decode: host ms a batch issuing the RANSAC subset and minimal-set
draws (`ops/pnp.py::_ransac_prepare`): the program's
`zebrapose.decode.ransac_prepare` span, which the decode opens inside the
serving step."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.serve.step",
                         "zebrapose.decode.ransac_prepare")
