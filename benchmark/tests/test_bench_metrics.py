"""The metric arithmetic: the union of kernel intervals, a p95 over every
batch, rooflines and mfu as least time over time, and the yardstick's
FLOP count tied to the port's own."""

from __future__ import annotations

import pytest
import torch

from benchmark import flops, harness
from benchmark.metrics import _common


def test_union_counts_overlap_once():
    # two streams overlapping by 2: busy 8, not the summed 10
    assert harness.union_length([(0, 5), (3, 8)]) == 8
    assert harness.union_length([(0, 1), (2, 3), (2.5, 4)]) == 3
    assert harness.union_length([]) == 0


def test_reduce_trace_busy_idle_and_gap_names():
    dev = [("k1", 10, 20), ("k2", 15, 30), ("memcpy", 50, 60),
           ("early", 0, 12)]
    host = [("bench.step", 0, 45), ("aten::item", 30, 44),
            ("bench.fetch", 45, 70)]
    r = harness.reduce_trace(dev, host, (5, 70))
    assert r["busy_s"] == pytest.approx((30 - 5 + 10) / 1e6)
    assert r["window_s"] == pytest.approx(65 / 1e6)
    assert r["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    # the longest gap, 30 -> 50, starts while the step waits in item()
    assert r["idle_gaps"][0][0] == "bench.step/aten::item"
    assert r["idle_gaps"][0][1] == pytest.approx(20e-6)


def test_p95_is_over_every_batch_a_stall_included():
    lat = [100.0] * 99 + [5000.0]
    assert harness.percentile(lat, 95) == pytest.approx(100.0)
    lat = [100.0] * 90 + [5000.0] * 10
    # ten stalls in a hundred lie above the 95th percentile's place
    assert harness.percentile(lat, 95) == pytest.approx(5000.0)
    assert harness.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def _run(kernel_s, batches=4, window_s=2.0, **kw):
    cfg = harness.load_json(harness.BENCH / "configs" /
                            "zebrapose-v2-r34-int8.json")
    prof = {"kernel_s": kernel_s, "kernel_count": {k: 1 for k in kernel_s},
            "batches": batches, "window_s": window_s, "busy_s": 0.5}
    return dict(config=cfg, batch=8, profile=prof,
                conv_layers=flops.conv_layers(cfg, 8), **kw)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def test_roofline_is_least_time_over_time():
    cfg = harness.load_json(harness.BENCH / "configs" /
                            "zebrapose-v2-r34-int8.json")
    pk = cfg["peaks"]
    least = flops.epnp_least_seconds(8 * 128, 5, pk)
    run = _run({"void epnp_minimal_kernel(float*)": 4 * 2 * least})
    assert _reader("epnp_minimal_roofline").read(run) == pytest.approx(50.0)
    layers = [c for c in flops.conv_layers(cfg, 8) if c["quantized"]]
    assert len(layers) == 37
    conv = sum(flops.int8_conv_least_seconds(c, pk) for c in layers)
    run = _run({"wgmma_conv_kernel<bf16>": 4 * conv * 4})
    assert _reader("int8_conv2d_roofline").read(run) == pytest.approx(25.0)
    q = sum(flops.quantize_act_least_seconds(c, pk) for c in layers)
    run = _run({"absmax_kernel": 4 * q, "quantize_kernel": 4 * q})
    assert _reader("quantize_act_roofline").read(run) == pytest.approx(50.0)
    # a reader with nothing to read gives nothing, never 0
    assert _reader("epnp_minimal_roofline").read(_run({})) is None
    assert _reader("epnp_minimal_roofline").read({"config": cfg}) is None


def test_mfu_and_idle():
    run = _run({"k": 1.0}, batches=4, window_s=2.0)
    least = flops.forward_least_seconds(run["conv_layers"],
                                        run["config"]["peaks"])
    assert _reader("mfu.serve").read(run) == pytest.approx(
        100 * least / 0.5)
    assert _reader("device_idle_pct.serve").read(run) == pytest.approx(75.0)
    train = _run({"k": 1.0}, batches=4, window_s=2.0)
    assert _reader("mfu.train").read(train) == pytest.approx(
        100 * 3 * flops.forward_flops(train["conv_layers"])
        / run["config"]["peaks"]["bf16_flops_per_s"] / 0.5)
    assert _common.mean([1.0, 2.0, 6.0]) == 3.0
    assert _common.mean([]) is None


def test_conv_flops_equal_the_ports_model_cost():
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.utils.profiling import model_cost

    cfg = harness.load_json(harness.BENCH / "configs" /
                            "zebrapose-v2-r34.json")
    with torch.device("meta"):
        model = ZebraPoseNet(16, 2, "v2")
        x = torch.empty(2, 256, 256, 3)
    assert flops.forward_flops(flops.conv_layers(cfg, 2)) == \
        model_cost(model, x)["flops"]


@pytest.mark.parametrize("config,quantized", [
    ("zebrapose-v2-r34", 0), ("zebrapose-v2-r34-int8", 37)])
def test_conv_layers_of_each_configuration_are_pinned(config, quantized):
    # the denominators of both mfu metrics and of the int8 rooflines:
    # how the reference network is found and built may not move them
    cfg = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    layers = flops.conv_layers(cfg, 256)
    assert len(layers) == 49
    assert sum(c["transposed"] for c in layers) == 2
    assert flops.forward_flops(layers) == 27941513723904
    assert sum(c["quantized"] for c in layers) == quantized


def test_frozen_counts_equal_their_sources():
    import chip_smoke

    for gn in (0, 3, 5):
        assert flops.epnp_operations(gn) == chip_smoke.epnp_operations(gn)
    cfg = harness.load_json(harness.BENCH / "configs" /
                            "zebrapose-v2-r34-int8.json")
    layers = [c for c in flops.conv_layers(cfg, 256) if c["quantized"]]
    pk = cfg["peaks"]
    # the summed bounds a b256 forward's 37 convs were held to (PR 11)
    assert sum(flops.int8_conv_least_seconds(c, pk) for c in layers) * 1e3 \
        == pytest.approx(13.067, abs=5e-4)
    assert sum(flops.quantize_act_least_seconds(c, pk) for c in layers) \
        * 1e3 == pytest.approx(4.838, abs=5e-4)
