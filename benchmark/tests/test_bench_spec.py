"""BENCHMARK.json keeps to its contract, and every name in it finds its
file."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [c["name"] for c in SPEC["configs"]]
                         + [w["traffic"] for w in SPEC["workloads"]])
def test_names_keep_to_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")


def test_unique_names():
    for group in ([m["name"] for m in METRICS],
                  [w["name"] for w in SPEC["workloads"]],
                  [c["name"] for c in SPEC["configs"]]):
        assert len(group) == len(set(group))


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_that_each_of_its_cells_reports(metric):
    for cell in metric["workloads"]:
        reported = {m["name"] for m in harness.Cell(SPEC, cell).end_to_end()}
        assert metric["moves"] in reported, (metric["name"], cell)


@pytest.mark.parametrize("workload", SPEC["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_enough(workload):
    cell = harness.Cell(SPEC, workload["name"])
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    assert cell.driver().run
    for m in cell.per_layer():
        assert cell.reader(m["name"]).read
    assert workload["chips"] == 1


def test_layers_are_named_alike_and_bounds_kept():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_under_paths_and_cuts_no_width(entry):
    assert entry["file"].startswith("benchmark/configs/")
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["shapes"]["crop_img"] == 256 and cfg["shapes"]["crop_gt"] == 128
    assert cfg["network"]["code_bits"] == 16
    assert set(cfg["limits"]["serve"]) and all(
        v >= 0 for v in cfg["limits"]["serve"].values())


def test_free_text_fits_on_one_line():
    texts = ([w["why"] for w in SPEC["workloads"]]
             + [c["why"] for c in SPEC["configs"]]
             + [c["source"] for c in SPEC["configs"]]
             + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len(json.dumps(SPEC)) < 64 * 1024
