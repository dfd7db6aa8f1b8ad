"""Decode (binarize, LUT correspondences, RANSAC, EPnP, scoring): mean
device span per batch, ms, from the CUDA event at the forward's end to
the one after the step returns."""

from benchmark.metrics._common import mean


def read(run):
    return mean(run.get("decode_ms"))
