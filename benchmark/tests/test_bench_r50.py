"""The ResNet50 family (`zebrapose-v2-r50`): the frozen reference
(`reference/nets/v2_r50_base2.py`) matches the port's own network on
weights drawn from a seed, a float32 training step follows it, the
yardstick's conv count is pinned; and `conv_roofline.train` reads the
convolution kernels of a reduced trace, each once.

The full-width ResNet50 holds 340 M parameters: the training step keeps
~14 GB of float32 state on the CPU (two models with their gradients and
Adam's moments, and the snapshots), so it runs one step and frees both
sides before it ends."""

from __future__ import annotations

import gc

import pytest
import torch

from benchmark import flops, harness

CONFIG = "zebrapose-v2-r50.json"


def _config():
    return harness.load_json(harness.BENCH / "configs" / CONFIG)


def test_forward_matches_the_ports_resnet50():
    from benchmark.drivers.train import init_weights
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    cfg = _config()
    port = ZebraPoseNet(16, 2, "v2", resnet_layers=50)
    ref = harness.reference_network(cfg)
    weights = init_weights(port.state_dict(), 11, torch.device("cpu"))
    port.load_state_dict(weights, strict=True)
    ref.load_state_dict(weights, strict=True)
    # the keys and shapes are the same both ways
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    del weights
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port.eval()(x), ref.eval()(x)
    assert set(a) == set(b) == {"mask", "entire_mask", "code"}
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_train_step_matches_in_float32():
    from benchmark import checks
    from benchmark.drivers import train as drv
    from benchmark.tests.tiny import TRAIN_TINY, TinyCell

    cell = TinyCell(CONFIG, dict(TRAIN_TINY, batch=2, checked_steps=1))
    cell.config["train"]["bf16_autocast"] = False
    dev = torch.device("cpu")
    split = drv.Split(cell.config, cell.traffic, 7, dev)
    trainer = drv.Trainer(cell.config, cell.traffic, 7, dev, split)
    snap = trainer.checked_steps(1)
    init = trainer.init
    # the program's model, gradients and moments go before the
    # reference's are made, as `drivers/train.py::run` does
    del trainer
    gc.collect()
    try:
        num = checks.train_numbers(cell.config, cell.traffic, 7, split,
                                   init, snap, dev)
    finally:
        del snap, init, split
        gc.collect()
    assert num["input_mismatch"] == 0 and num["batch_err"] == 0
    assert num["loss_gap_1"] < 1e-5
    # in float32 the first forward follows the reference: the cell's
    # bf16 gap (0.15-0.22) is the seeded network's, not a mismatch
    assert num["logit_rel_1"] < 1e-4
    assert num["grad_gap_median_leaf"] < 1e-4


def test_conv_layers_are_pinned_and_equal_the_ports_model_cost():
    # the denominators of mfu.train and conv_roofline.train in
    # train-r50-b32: how the reference network is built may not move them
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.utils.profiling import model_cost

    cfg = _config()
    layers = flops.conv_layers(cfg, 256)
    assert len(layers) == 57
    assert sum(c["transposed"] for c in layers) == 2
    assert flops.forward_flops(layers) == 191408170336256
    assert sum(c["quantized"] for c in layers) == 0
    with torch.device("meta"):
        model = ZebraPoseNet(16, 2, "v2", resnet_layers=50)
        x = torch.empty(2, 256, 256, 3)
    assert flops.forward_flops(flops.conv_layers(cfg, 2)) == \
        model_cost(model, x)["flops"]


def _conv_roofline():
    return harness.load_module(
        harness.BENCH / "metrics" / "conv_roofline.train.py",
        "m_conv_roofline_train")


def _run(kernel_s, batches=4):
    cfg = _config()
    prof = {"kernel_s": kernel_s, "kernel_count": {k: 1 for k in kernel_s},
            "batches": batches, "window_s": 2.0, "busy_s": 1.5}
    return dict(config=cfg, batch=8, profile=prof,
                conv_layers=flops.conv_layers(cfg, 8))


def test_conv_roofline_divides_by_the_convolution_kernels_only():
    run = _run({})
    least = 3 * flops.forward_flops(run["conv_layers"]) / \
        run["config"]["peaks"]["bf16_flops_per_s"]
    conv = {
        # two needles in one name: counted once
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc": 1.0,
        "void cudnn::cnn::wgrad_alg1_engine<__nv_bfloat16, float, 128>": 0.5,
        "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32": 0.25,
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": 0.125,
        "cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>": 0.125}
    other = {
        "void at::native::batch_norm_collect_statistics_channels_last": 3.0,
        "void at::native::vectorized_elementwise_kernel<8, AddFunctor>": 2.0,
        "void at::native::(anonymous namespace)::multi_tensor_apply": 1.0}
    run = _run({**conv, **other}, batches=4)
    reader = _conv_roofline()
    assert set(reader.conv_kernels(run["profile"])) == set(conv)
    assert reader.read(run) == pytest.approx(100 * least / (2.0 / 4))


def test_conv_roofline_needs_a_profile_and_a_convolution_kernel():
    reader = _conv_roofline()
    assert reader.read({"config": _config()}) is None
    assert reader.read(dict(_run({}), profile=None)) is None
    run = _run({"void at::native::batch_norm_backward_reduce": 1.0,
                "void at::native::vectorized_elementwise_kernel": 1.0})
    with pytest.raises(harness.BenchError, match="no convolution kernel"):
        reader.read(run)
