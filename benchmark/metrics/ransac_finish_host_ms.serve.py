"""Decode: host ms a batch issuing the scoring, refit, polish and gate
(`ops/pnp.py::_ransac_finish`): the program's
`zebrapose.decode.ransac_finish` span, which the decode opens inside the
serving step."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.serve.step",
                         "zebrapose.decode.ransac_finish")
