"""Build and load the port's host C++ libraries.

Each ``ofasys_torch/csrc/host/<name>.cpp`` has a plain C interface. It is
compiled with ``$CXX`` (default ``c++``) into
``ofasys_torch/_build/lib<name>.so`` at first use (or ahead of it, all
sources in parallel, by :func:`build`) and loaded with ``ctypes``, as
``cuda_build`` does for the CUDA kernels. No ``nvcc`` is needed: these
libraries build wherever a C++17 compiler is. A library newer than its
source and the shared headers (``csrc/host/*.h``) is reused.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Iterable

from ofasys_torch.ops.cuda_build import BUILD_DIR, CSRC, compile_all, newer

HOST_CSRC = CSRC / "host"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _paths(name: str):
    return HOST_CSRC / f"{name}.cpp", BUILD_DIR / f"lib{name}.so"


def _fresh(name: str) -> bool:
    """The library exists and is newer than its source and than every
    shared header of ``csrc/host/``."""
    src, lib = _paths(name)
    return newer(lib, [src, *HOST_CSRC.glob("*.h")])


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that need it, one compiler each, all
    started together. Returns the compiler's output per compiled name;
    raises with that output on any failure, or when ``$CXX`` cannot be
    started."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or "c++"
    jobs = {}
    for name in names:
        if not _fresh(name):
            src, lib = _paths(name)
            jobs[name] = ([cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", "{out}", str(src)], src, lib)
    return compile_all(jobs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/host/<name>.cpp``, building it if
    needed."""
    with _lock:
        if name not in _libs:
            if not _fresh(name):
                build([name])
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]
