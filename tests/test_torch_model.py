"""Port parity for the network: flax ZebraPoseNet weights carried into
`zebrapose_tpu_torch` by `variables_to_state_dict`, strict-loaded, and
the forwards compared in float32 at 64² (the shapes of
tests/test_model_parity.py, within its 2e-4). Also the compact
checkpoint reader against the JAX one on the committed
`trained/rehearsal3_best.npz`.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.models.zebra_net import normalize_image as j_normalize
from zebrapose_tpu.utils.compact_ckpt import load_compact as j_load_compact
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.layers import interpolate_bilinear
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet, normalize_image
from zebrapose_tpu_torch.utils.compact_ckpt import load_compact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "trained", "rehearsal3_best.npz")


def flax_variables(variant, rng, n_bits=16, **net_kw):
    """flax-initialized variables at 64², with BatchNorm statistics and
    affine parameters randomized so BN is not the identity."""
    model = JNet(binary_code_length=n_bits, variant=variant, **net_kw)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    v = jax.tree.map(np.asarray, v)

    def perturb(tree, kind):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = perturb(x, kind)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
            else:
                out[k] = x
        return out

    return {"params": perturb(v["params"], "params"),
            "batch_stats": perturb(v["batch_stats"], "stats")}


@pytest.mark.parametrize("variant,net_kw", [
    ("v2", {}),
    ("v1", {}),
    ("v2", {"concat": False, "output_kernel_size": 3}),
])
def test_forward_parity_with_carried_weights(variant, net_kw):
    rng = np.random.default_rng(21)
    variables = flax_variables(variant, rng, **net_kw)
    model = ZebraPoseNet(binary_code_length=16, variant=variant,
                         **net_kw).eval()
    model.load_state_dict(variables_to_state_dict(variables, variant),
                          strict=True)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: JNet(binary_code_length=16, variant=variant,
                                     **net_kw).apply(
        v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        err = np.abs(got[name].numpy() - np.asarray(want[name])).max()
        assert err < 2e-4, f"{variant}/{name} max err {err}"


def test_interpolate_and_normalize_match_jax():
    from zebrapose_tpu.models.layers import interpolate_bilinear as j_interp

    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    for out in [(8, 8), (32, 32), (5, 7)]:
        np.testing.assert_allclose(
            interpolate_bilinear(torch.from_numpy(x), out).numpy(),
            np.asarray(j_interp(jnp.asarray(x), out)), atol=1e-5)
    img = rng.random((2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        normalize_image(torch.from_numpy(img)).numpy(),
        np.asarray(j_normalize(jnp.asarray(img))), rtol=1e-6, atol=1e-6)


def test_compact_checkpoint_bit_equal_and_strict_loads():
    """The port's loader widens bf16 by bit shift (no ml_dtypes): every
    leaf bit-equal to the JAX loader's, and the tree strict-loads."""
    got, meta = load_compact(CKPT)
    want, want_meta = j_load_compact(CKPT)
    assert meta == want_meta

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].dtype == b[k].dtype, f"{path}/{k}"
                assert a[k].shape == b[k].shape, f"{path}/{k}"
                assert a[k].tobytes() == b[k].tobytes(), f"{path}/{k}"

    walk(got, want)
    head = got["params"]["aspp"]["conv_1x1_4"]["conv"]["kernel"]
    n_bits = head.shape[-1] - 2
    model = ZebraPoseNet(binary_code_length=n_bits, variant="v2")
    model.load_state_dict(variables_to_state_dict(got, "v2"), strict=True)
