"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the port, and a
run without a card fails rather than falling back to the CPU."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

SOURCES = sorted(p for p in harness.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_guard_compares_top_level_names_whole():
    assert harness.forbidden_modules(["zebrapose_tpu_torch",
                                      "zebrapose_tpu_torch.ops.pnp",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["zebrapose_tpu.ops.pnp"]) == \
        ["zebrapose_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib.xla", "flax",
                                      "numpy"]) == ["flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_anywhere(path):
    assert harness.forbidden_modules(_imports(path)) == []


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    mods = list(_imports(path))
    assert not {m.split(".")[0] for m in mods} & {"zebrapose_tpu_torch",
                                                  "zebrapose_tpu"}
    # a family's file under nets/ is loaded by path and so imports the
    # reference by absolute names: the reference, and nothing else of
    # the benchmark
    assert all(m.startswith("benchmark.reference.")
               for m in mods if m.split(".")[0] == "benchmark")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(["--workload", "serve-r34-b256", "--seed", "3", "--seconds",
              "1"], harness.ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    r = _run(["--workload", "train-r34-b32", "--seed", "3", "--seconds",
              "1"], tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_unknown_workload_is_refused():
    r = _run(["--workload", "nope", "--seed", "1", "--seconds", "1"],
             harness.ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
