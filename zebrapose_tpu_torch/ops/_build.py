"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled at
first use into a shared library under `zebrapose_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the flags, the source and
every file under `csrc/` that it includes (`#include "..."`, followed
recursively), so an edited source or header rebuilds and an unchanged
one loads in milliseconds.
No PyTorch headers are included: nvcc takes seconds, not minutes.

Flags: sm_90a, -O3, and NOT --use_fast_math — fast math changes sqrtf,
division and powf, and the kernels must track their plain PyTorch
versions step for step. `-Xptxas -v` reports registers and spills; the
report is kept beside the library (`build_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def sources(name: str, csrc: Path = CSRC) -> List[Path]:
    """`csrc/<name>.cu` and every file under `csrc` that it includes with
    quotes, directly or through another such file, in the order found.
    Includes resolve against the including file's directory, as nvcc
    resolves them; a name that is not a file under `csrc` is a system
    header and is skipped."""
    root = csrc.resolve()
    found: List[Path] = []
    todo = [root / f"{name}.cu"]
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


def _target(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    root = csrc.resolve()
    for path in sources(name, csrc):
        h.update(str(path.relative_to(root)).encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every missing library, one nvcc per source, all started
    together. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    """nvcc's -Xptxas -v report (registers, spills) for `name`."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
