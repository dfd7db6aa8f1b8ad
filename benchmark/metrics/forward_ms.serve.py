"""Model forward: mean device span per batch, ms, by the CUDA events the
harness records around the forward_fn it hands to make_eval_step."""

from benchmark.metrics._common import mean


def read(run):
    return mean(run.get("forward_ms"))
