"""On the card: each cell runs end to end through `run.py` and prints a
correct result line; a checkout of the benchmark alone gives none."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _run(args, cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=1200)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_correct(card, workload, trace):
    r = _run(["--workload", workload, "--seed", "2147483999", "--seconds",
              "5", "--trace", trace], harness.ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["device"]["memory_peak_bytes"] > 0
    cell = harness.Cell(SPEC, workload)
    want = cell.per_layer() if trace == "1" else cell.end_to_end()
    assert {m["name"] for m in want} == set(out["metrics"])
    if trace == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
    assert r.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
def test_the_benchmark_alone_gives_no_result(card, tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    r = _run(["--workload", "serve-r34-b256", "--seed", "1", "--seconds",
              "1"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
