"""A configuration, a traffic mix and a metric dropped into a copy of the
benchmark as files of their own are found by name, with no file that is
there edited."""

from __future__ import annotations

import json
import shutil

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
