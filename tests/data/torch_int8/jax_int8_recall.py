"""The JAX package's `test --int8` and `test-fleet --int8` recalls on the
trees `python3 chip_smoke.py --write-tree DIR` writes (JAX_CPU_INT8 in
chip_smoke.py).

    JAX_PLATFORMS=cpu python tests/data/torch_int8/jax_int8_recall.py DIR

runs `python -m zebrapose_tpu test --batch_size 32 --int8` over
DIR/lmo_ape.txt and `test-fleet --batch_size 32 --int8` (ape and can,
the committed checkpoint for both) over DIR/fleet/lmo_fleet.txt, through
`zebrapose_tpu.cli.main`, and prints their ADD recall@0.1d as JSON.

One change to the JAX program, which leaves its numbers as they are:
XLA's CPU convolution of int8 operands with int32 accumulation (the one
`_Int8Conv` calls, zebrapose_tpu/models/layers.py:57) did not finish
120 frames in 40 minutes on an 8-core host. Here that call is computed
as float32 convolutions over groups of at most 115 input channels, each
cast to int32 and summed in int32: every product is an integer of at
most 127^2 and every group's sum stays below 2^24, so each float32 sum
is exact in any order, and the int32 total equals XLA's int32
accumulator bit for bit (checked first against XLA's int8 convolution
on small inputs of 1x1 and dilated 3x3 kernels, where it is fast).
Every other operation is the JAX package's own.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
sys.path.insert(0, REPO)

import numpy as np

_conv = jax.lax.conv_general_dilated


def exact_int8_conv(lhs, rhs, *args, preferred_element_type=None, **kw):
    if lhs.dtype != jnp.int8 or preferred_element_type != jnp.int32:
        return _conv(lhs, rhs, *args,
                     preferred_element_type=preferred_element_type, **kw)
    dn = kw.get("dimension_numbers")
    if dn != ("NHWC", "HWIO", "NHWC"):
        raise ValueError(f"unexpected layout {dn}")
    cin = lhs.shape[-1]
    kh, kw_ = rhs.shape[:2]
    group = max(1, (1 << 24) // (kh * kw_ * 127 * 127))
    acc = None
    for c0 in range(0, cin, group):
        part = _conv(lhs[..., c0:c0 + group].astype(jnp.float32),
                     rhs[:, :, c0:c0 + group].astype(jnp.float32), *args,
                     precision=jax.lax.Precision.HIGHEST, **kw)
        part = part.astype(jnp.int32)
        acc = part if acc is None else acc + part
    return acc


def self_check():
    """exact_int8_conv against XLA's int8 convolution on small inputs at
    the channel counts whose sums pass 2^24."""
    rng = np.random.default_rng(0)
    for k, cin, dil in ((1, 1280, 1), (3, 512, 6), (3, 256, 2)):
        # near-full magnitudes, so the sums pass 2^24; half the output
        # channels negated
        x = jnp.asarray(rng.integers(120, 128, (2, 9, 9, cin)), jnp.int8)
        w = rng.integers(120, 128, (k, k, cin, 16))
        w = jnp.asarray(w * np.where(np.arange(16) % 2, -1, 1), jnp.int8)
        kw = dict(window_strides=(1, 1), padding=((dil, dil), (dil, dil))
                  if k == 3 else ((0, 0), (0, 0)), rhs_dilation=(dil, dil),
                  dimension_numbers=("NHWC", "HWIO", "NHWC"),
                  preferred_element_type=jnp.int32)
        want = np.asarray(_conv(x, w, **kw))
        got = np.asarray(exact_int8_conv(x, w, **kw))
        assert np.array_equal(got, want), (k, cin, dil)
        assert np.abs(want).max() > 1 << 24          # past f32's integers


def _last_json(text):
    return json.loads(text[text.rindex("\n{\n") + 1:])


def main(root):
    import contextlib
    import io

    self_check()
    jax.lax.conv_general_dilated = exact_int8_conv
    from zebrapose_tpu import cli

    ckpt = os.path.join(REPO, "trained", "rehearsal3_best.npz")
    out = os.path.join(root, "jax_int8_runs")
    res = {}
    cli.main(["test", "--cfg", os.path.join(root, "lmo_ape.txt"),
              "--obj_name", "ape", "--ckpt_file", ckpt, "--batch_size",
              "32", "--int8", "--output_dir", os.path.join(out, "test")])
    (run,) = os.listdir(os.path.join(out, "test"))
    with open(os.path.join(out, "test", run, "ADD_result.txt")) as f:
        res["test"] = dict(ln.split() for ln in f.read().splitlines())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["test-fleet", "--cfg", os.path.join(root, "fleet",
                                                      "lmo_fleet.txt"),
                  "--obj_names", "ape", "can", "--ckpt_files", ckpt, ckpt,
                  "--batch_size", "32", "--int8", "--output_dir",
                  os.path.join(out, "fleet")])
    fleet = _last_json(buf.getvalue())["per_object"]
    res["test_fleet"] = {n: fleet[n]["ADD_recall_0.1d"] for n in fleet}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    sys.exit(main(os.path.abspath(sys.argv[1])))
