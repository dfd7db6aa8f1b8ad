"""Model forward: host ms a batch issuing the forward and the logits'
cast to float32: the program's `zebrapose.serve.forward` span."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.serve.step",
                         "zebrapose.serve.forward")
