"""A configuration, a traffic mix, a metric and a family's reference
network dropped into a copy of the benchmark as files of their own are
found by name, with no file that is there edited."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from benchmark import harness


def test_new_files_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "zebrapose-v2-r34.json").read_text())
    cfg["name"] = "dummy-config"
    (bench / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"driver": "serve", "batch": 2}))
    (bench / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "dummy-config", "source": "x",
                            "file": "benchmark/configs/dummy-config.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "crops_per_s",
                              "workloads": ["dummy-cell"]})
    spec["end_to_end"][0]["workloads"].append("dummy-cell")
    cell = harness.Cell(spec, "dummy-cell", bench=bench)
    assert cell.config["name"] == "dummy-config"
    assert cell.traffic["batch"] == 2
    assert cell.driver().__file__ == str(bench / "drivers" / "serve.py")
    names = [m["name"] for m in cell.per_layer()]
    assert names == ["dummy_ms.serve"]
    assert cell.reader("dummy_ms.serve").read({}) == 42.0
    assert {m["name"] for m in cell.end_to_end()} == {"crops_per_s",
                                                      "setup_s"}


def _tree(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_family_is_built_from_its_own_file(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _tree(bench)
    cfg = json.loads((bench / "configs" / "zebrapose-v2-r34.json").read_text())
    cfg["network"]["resnet_layers"] = 50
    family = bench / "reference" / "nets" / "v2_r50_base2.py"
    with pytest.raises(harness.BenchError, match=re.escape(str(family))):
        harness.reference_network(cfg, bench=bench)
    family.write_text(
        "from torch import nn\n\n\n"
        "def build(net, quant=False):\n"
        "    m = nn.Conv2d(3, net['code_bits'] + 2, 1)\n"
        "    m.family = (net['variant'], net['resnet_layers'], quant)\n"
        "    return m\n")
    for quant in (False, True):
        model = harness.reference_network(cfg, quant=quant, bench=bench)
        assert model.family == ("v2", 50, quant)
        assert model.out_channels == 18
    after = _tree(bench)
    assert set(after) - set(before) == {family.relative_to(bench)}
    assert all(after[k] == v for k, v in before.items())


def test_each_family_in_benchmark_json_has_its_file():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        with torch.device("meta"):
            model = harness.reference_network(cfg).eval()
        out = model(torch.empty(1, 64, 64, 3, device="meta"))
        assert set(out) >= {"mask", "code"}
        assert out["code"].shape == (1, 32, 32, cfg["network"]["code_bits"])
