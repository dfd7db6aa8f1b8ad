"""The kernel library's name follows every source it is built from.

`zebrapose_tpu_torch/ops/_build.py` names each library by a hash of the
nvcc flags, `csrc/<name>.cu` and every file under `csrc/` that it
includes, so an edited header rebuilds. These tests work on a copy of
`csrc/` in a temporary directory and run no nvcc.
"""

import shutil

import pytest

from zebrapose_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    root = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, root)
    src = root / "epnp_minimal.cu"
    src.write_text('#include "epnp_math.cuh"\n' + src.read_text())
    (root / "epnp_math.cuh").write_text(
        '#pragma once\n#include "detail/inner.cuh"\n'
        '__device__ inline float twice(float x) { return 2.f * x; }\n')
    (root / "detail").mkdir()
    (root / "detail" / "inner.cuh").write_text(
        "__device__ inline float thrice(float x) { return 3.f * x; }\n")
    return root


def test_target_is_stable_for_the_shipped_sources():
    assert _build._target("epnp_minimal") == _build._target("epnp_minimal")
    assert _build.sources("epnp_minimal") == [
        (_build.CSRC / "epnp_minimal.cu").resolve()]


def test_sources_follow_quoted_includes_recursively(csrc):
    names = [p.relative_to(csrc.resolve()).as_posix()
             for p in _build.sources("epnp_minimal", csrc)]
    assert names == ["epnp_minimal.cu", "epnp_math.cuh", "detail/inner.cuh"]


@pytest.mark.parametrize("edited", ["epnp_minimal.cu", "epnp_math.cuh",
                                    "detail/inner.cuh"])
def test_editing_any_source_changes_the_target(csrc, edited):
    before = _build._target("epnp_minimal", csrc)
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _build._target("epnp_minimal", csrc) != before


def test_files_it_does_not_include_leave_the_target(csrc):
    before = _build._target("epnp_minimal", csrc)
    (csrc / "unrelated.cuh").write_text("// not included\n")
    (csrc / "other.cu").write_text('#include "unrelated.cuh"\n')
    assert _build._target("epnp_minimal", csrc) == before


def test_system_headers_and_missing_files_are_skipped(csrc):
    src = csrc / "epnp_minimal.cu"
    src.write_text('#include "cuda_runtime.h"\n#include "nowhere/x.cuh"\n'
                   + src.read_text())
    names = [p.name for p in _build.sources("epnp_minimal", csrc)]
    assert names == ["epnp_minimal.cu", "epnp_math.cuh", "inner.cuh"]


def test_an_include_cycle_ends(csrc):
    (csrc / "detail" / "inner.cuh").write_text('#include "../epnp_math.cuh"\n')
    names = [p.name for p in _build.sources("epnp_minimal", csrc)]
    assert names == ["epnp_minimal.cu", "epnp_math.cuh", "inner.cuh"]
