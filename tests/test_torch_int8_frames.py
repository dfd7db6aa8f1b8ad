"""`test --int8` frame by frame against the JAX package, at a cut size
(4 frames, one batch of 4), on the CPU: the whole path (crop, int8
network, RANSAC with the JAX package's draws injected, ADD) through
`tests/data/torch_int8/int8_frames.py`, whose full run over the
120-frame tree is recorded in PERF.md.

What is held, and why not more: each quantized conv is exact against
JAX's on JAX's own input (test_torch_int8.py), but float differences of
an ulp in the layers between them move values across a rounding
boundary of a later quantizer. So the two int8 networks' hard code bits
differ on a few hundred of a frame's 262144, as many as the JAX
network's own bits move when its crops get N(0, 1e-6) noise: 0.95x
that yardstick at these 4 frames, 1.05x over the 120 (PERF.md, C1). The
test holds the port to 1.3x; an activation and weight scale of amax /
126 in place of / 127 gives 1.74x. Verdicts are not held:
with identical bits and draws, float32 minimal-set EPnP on
near-degenerate sets parts the two stacks' poses (PERF.md, C1).
"""

import os
import sys

import numpy as np

import chip_smoke
import torch_threads  # noqa: F401  (torch threads a worker)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data",
                                "torch_int8"))
import int8_frames  # noqa: E402


def test_int8_frames_match_jax_up_to_rounding(tmp_path):
    chip_smoke.write_tree(str(tmp_path), n_frames=4)
    res = int8_frames.compare(str(tmp_path), batch_size=4, noise_run=False)
    assert res["frames"] == 4 and res["code_bits_per_frame"] == 128 ** 2 * 16
    assert np.isfinite(res["jax_errors"]).all()
    assert np.isfinite(res["port_errors"]).all()
    assert max(res["jax_errors"] + res["port_errors"]) < 1e4   # all solved
    assert res["noise_flips"] > 0
    assert sum(res["code_bits"]) <= 1.3 * res["noise_flips"], res
    assert max(res["mask_px"]) <= 8, res
