"""Training input: mean device span per step, ms, of the harness's call
for the next batch (CachedBatchIterator's draw, then
gather_preprocess_batch: gather, crop, augment, code planes), by CUDA
events around it."""

from benchmark.metrics._common import mean


def read(run):
    return mean(run.get("batch_ms"))
