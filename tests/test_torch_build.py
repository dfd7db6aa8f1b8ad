"""The native libraries' names follow every source they are built from.

`zebrapose_tpu_torch/ops/_build.py` names each library by a hash of the
compiler flags, `csrc/<name>.cu` (nvcc) or `csrc/<name>.cpp` (c++) and
every file under `csrc/` that it includes, so an edited header rebuilds.
These tests work on a copy of `csrc/` in a temporary directory and run
no nvcc; the host route's tests compile a small C++ file with c++.
"""

import ctypes
import hashlib
import shutil

import pytest

import torch_threads  # noqa: F401  (torch threads a worker)
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
    assert _build.sources("zebra_native") == [
        (_build.CSRC / "zebra_native.cpp").resolve()]
    assert _build.sources("image_decode") == [
        (_build.CSRC / "image_decode.cpp").resolve()]


@pytest.mark.parametrize("name", ["epnp_minimal", "zebra_native",
                                  "image_decode"])
def test_target_hashes_the_route_flags_and_sources(name):
    """The kernel keeps the name it had before the host route existed
    (nvcc flags, then each source's path and bytes); the host library is
    named the same way from the c++ flags."""
    flags = _build.NVCC_FLAGS if name == "epnp_minimal" else _build.CXX_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _build.sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    assert _build._target(name).name == f"lib{name}_{h.hexdigest()[:16]}.so"
    assert "-ffast-math" not in _build.CXX_FLAGS
    assert not any(f.startswith("-march") for f in _build.CXX_FLAGS)


def test_host_route_builds_with_cxx_and_raises_without_it(csrc, tmp_path,
                                                          monkeypatch):
    """A .cpp source is built with $CXX at first use into the build
    directory; a missing compiler raises with what went wrong, and there
    is nothing to fall back to."""
    (csrc / "twice.cpp").write_text(
        'extern "C" int zn_twice(int x) { return 2 * x; }\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="cannot run no-such-compiler"):
        _build.load("twice")
    monkeypatch.setenv("CXX", "c++")
    assert _build.load("twice").zn_twice(ctypes.c_int(21)) == 42
    assert _build._target("twice", csrc).exists()
    (csrc / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken: c\\+\\+ exit"):
        _build.build(["broken"])
    with pytest.raises(FileNotFoundError, match="absent"):
        _build.build(["absent"])


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
