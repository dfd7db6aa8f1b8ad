"""Build and load the port's native libraries (nvcc or c++, + ctypes).

Each `csrc/<name>.cu` (a CUDA kernel) or `csrc/<name>.cpp` (host C++)
exposes a plain C interface and is compiled at first use into a shared
library under `zebrapose_tpu_torch/_build/` (listed in .gitignore),
named by a hash of the flags, the source and every file under `csrc/`
that it includes (`#include "..."`, followed recursively), so an edited
source or header rebuilds and an unchanged one loads in milliseconds.
No PyTorch headers are included: a build takes seconds, not minutes.

CUDA flags: sm_90a, -O3, and NOT --use_fast_math — fast math changes
sqrtf, division and powf, and the kernels must track their plain
PyTorch versions step for step. `-Xptxas -v` reports registers and
spills; the report is kept beside the library (`build_log`).

Host C++ flags: those of `native/Makefile` that change the code
(-O3 -std=c++17 -fPIC -shared), with `c++` or `$CXX`; no -ffast-math
and no -march=native, so the port's copy of the JAX package's host
library computes the same bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _cxx() -> str:
    return os.environ.get("CXX", "c++")


def _source(name: str, csrc: Optional[Path] = None) -> Path:
    """`csrc/<name>.cu`, else `csrc/<name>.cpp` (`csrc`: CSRC)."""
    csrc = csrc or CSRC
    for ext in (".cu", ".cpp"):
        path = csrc.resolve() / f"{name}{ext}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {name}.cu or {name}.cpp under {csrc}")


def _compiler(src: Path) -> Tuple[str, Tuple[str, ...]]:
    """The compiler and flags for a source: nvcc for .cu, c++ else."""
    return (_nvcc(), NVCC_FLAGS) if src.suffix == ".cu" else \
        (_cxx(), CXX_FLAGS)


def sources(name: str, csrc: Optional[Path] = None) -> List[Path]:
    """`csrc/<name>.cu` (or `.cpp`) and every file under `csrc` that it
    includes with quotes, directly or through another such file, in the
    order found. Includes resolve against the including file's
    directory, as the compilers resolve them; a name that is not a file
    under `csrc` is a system header and is skipped."""
    csrc = csrc or CSRC
    root = csrc.resolve()
    found: List[Path] = []
    todo = [_source(name, csrc)]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file() and root in dep.parents:
                todo.append(dep)
    return found


def _target(name: str, csrc: Optional[Path] = None) -> Path:
    csrc = csrc or CSRC
    h = hashlib.sha256(" ".join(_compiler(_source(name, csrc))[1]).encode())
    root = csrc.resolve()
    for path in sources(name, csrc):
        h.update(str(path.relative_to(root)).encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every missing library, one compiler process per source,
    all started together. Raises with the compiler's output if any build
    fails, or if the compiler is not found."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, failed = [], []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        src = _source(name)
        compiler, flags = _compiler(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        try:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        except OSError as e:
            log.close()
            failed.append(f"{name}: cannot run {compiler}: {e}")
            continue
        procs.append((name, out, tmp, log, proc))
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: {proc.args[0]} exit {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    """nvcc's -Xptxas -v report (registers, spills) for `name`."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, built if
    missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
