"""Quantization-aware training in the port (`models/layers.py::
_fake_quant_conv`, `train --qat`) against the JAX package's
`_FakeQuantConv`, on the CPU.

Inputs come from numpy seeds and go to both. The layer's forward and
its gradients (input, weight, bias) are held to JAX's in float32 within
1e-5 relative to each tensor's largest magnitude: both sides are float
convs over integer-valued operands, whose f32 sums may round in another
order once they pass 2^24. A whole-network gradient parity in float64
(fault C3's approach, tests/test_torch_train.py) is not available: the
JAX quant layers cast to float32 whatever the model's dtype.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_trainer import (  # noqa: F401  (fixtures)
    _hide_module_stubs,
    _write_cfg,
    tree,
)
from zebrapose_tpu.models.layers import TorchConv as JConv
from zebrapose_tpu_torch import cli
from zebrapose_tpu_torch.eval.runner import load_model_variables
from zebrapose_tpu_torch.models.layers import TorchConv
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

# (k, stride, dilation, padding, cin, cout, spatial, negative_peak)
CASES = {
    "3x3": (3, 1, 1, 1, 64, 256, 8, False),
    "3x3_stride2_dilation2": (3, 2, 2, 2, 128, 128, 9, False),
    "1x1_negative_peak": (1, 1, 1, 0, 128, 256, 6, True),
}


def _inputs(case):
    k, stride, dil, pad, cin, cout, hw, neg = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 10)
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    if neg:
        # the amax element is negative and lands on -127 exactly: the
        # clip's lower tie, gradient 0.5 there (torch.clamp would give 1)
        x.flat[7] = -6.0
    w = (rng.normal(size=(k, k, cin, cout)) * 0.05).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    cot = np.random.default_rng(99).normal(
        size=(2, (hw + 2 * pad - dil * (k - 1) - 1) // stride + 1,
              (hw + 2 * pad - dil * (k - 1) - 1) // stride + 1,
              cout)).astype(np.float32)
    return x, w, b, cot


def _close(got, want, name):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"{name}: max |port - jax| {err:.3g} of {scale:.3g}")
    assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_quant_conv_matches_jax(case):
    k, stride, dil, pad, cin, cout, _, neg = CASES[case]
    x, w, b, cot = _inputs(case)
    jconv = JConv(cout, k, stride, pad, dil, use_bias=True, quant="qat")

    def jloss(params, xx):
        y = jconv.apply({"params": {"conv": params}}, xx)
        return jnp.sum(y * cot), y

    (_, want_y), (want_gp, want_gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
            jnp.asarray(x))

    conv = TorchConv(cin, cout, k, stride, pad, dil, quant="qat")
    assert conv.quant == "qat"
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = conv(xt)
    (y.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()

    _close(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_y), "y")
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_gx), "dx")
    _close(conv.weight.grad.permute(2, 3, 1, 0).numpy(),
           np.asarray(want_gp["kernel"]), "dw")
    _close(conv.bias.grad.numpy(), np.asarray(want_gp["bias"]), "db")
    if neg:
        # the tie: half the straight-through gradient at the peak
        i = np.unravel_index(7, x.shape)
        gx = xt.grad.permute(0, 2, 3, 1).numpy()
        others = np.asarray(want_gx)
        assert gx[i] == pytest.approx(float(others[i]), rel=1e-5)
        sx = np.abs(x).max() / 127.0
        wq = np.round(w / (np.abs(w).max(axis=(0, 1, 2)) / 127.0))
        swx = sx * (np.abs(w).max(axis=(0, 1, 2)) / 127.0)
        full = (cot[i[:3]] * swx * wq[0, 0, i[3]]).sum() / sx
        assert gx[i] == pytest.approx(0.5 * full, rel=1e-4)


def test_qat_forward_tracks_int8_serving():
    """The QAT forward equals the int8 serving forward of the same
    weights to f32 accumulation error (tests/test_int8.py::
    test_qat_forward_matches_int8_serving for JAX)."""
    torch.manual_seed(0)
    m8 = ZebraPoseNet(binary_code_length=4, quant=True).eval()
    mq = ZebraPoseNet(binary_code_length=4, quant="qat").eval()
    mq.load_state_dict(m8.state_dict())
    x = torch.randn(2, 32, 32, 3)
    with torch.no_grad():
        a, b = m8(x), mq(x)
    for k in a:
        amax = a[k].abs().max().item() + 1e-9
        assert (a[k] - b[k]).abs().max().item() < 1e-4 * amax + 1e-5, k


def test_fit_qat_then_int8(tree, tmp_path):
    """`train --qat` from a float checkpoint (cfg.load_checkpoint) runs a
    few CPU steps with its pose validation, and its checkpoint
    strict-loads into an int8 model that `test --int8` runs."""
    cfg = _write_cfg(tree, tmp_path / "cfg.txt")
    out = tmp_path / "o"
    base = ["train", "--cfg", cfg, "--obj_name", "ape", "--device", "cpu",
            "--from_scratch", "--output_dir", str(out), "--log_freq", "2"]
    assert cli.main(base + ["--max_steps", "2"]) == 0
    base[base.index(cfg)] = _write_cfg(tree, tmp_path / "cfg2.txt",
                                       load_checkpoint=True)
    assert cli.main(base + ["--max_steps", "4", "--qat"]) == 0
    ckpt_dir = out / "lmo_ape" / "checkpoints" / "steps"
    last = sorted(os.listdir(ckpt_dir),
                  key=lambda n: int(n.split("_")[1].split(".")[0]))[-1]
    assert last == "step_6.pth"          # 2 float steps, then 4 QAT steps
    sd = load_model_variables(str(ckpt_dir / last))
    model = ZebraPoseNet(binary_code_length=16, quant=True)
    model.load_state_dict(sd, strict=True)
    metrics = (out / "lmo_ape" / "logs" / "metrics.jsonl").read_text()
    assert "val/" in metrics
    assert cli.main(["test", "--cfg", cfg, "--obj_name", "ape",
                     "--ckpt_file", str(ckpt_dir / last), "--int8",
                     "--batch_size", "2", "--output_dir",
                     str(tmp_path / "eval"), "--device", "cpu"]) == 0
