"""Serving entry: host ms a batch in the step's two uploads (the feed
dict, then final_bbox and K), which wait for the stream where the copy
is synchronous: the program's `zebrapose.serve.upload` spans."""

from benchmark.metrics._spans import stage_host_ms


def read(run):
    return stage_host_ms(run, "zebrapose.serve.step",
                         "zebrapose.serve.upload")
