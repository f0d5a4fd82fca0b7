"""Build and load the port's CUDA kernels.

Each ``ofasys_torch/csrc/<name>.cu`` has a plain C interface. It is compiled
with ``nvcc`` for ``sm_90a`` into ``ofasys_torch/_build/lib<name>.so`` at first
use (or ahead of it, all sources in parallel, by :func:`build`) and loaded
with ``ctypes``. A library newer than its source and the shared headers
(``csrc/*.cuh``) is reused.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def newer(lib: Path, deps: Iterable[Path]) -> bool:
    """``lib`` exists and is newer than every file of ``deps``."""
    return lib.exists() and lib.stat().st_mtime >= max(p.stat().st_mtime for p in deps)


def _fresh(name: str) -> bool:
    """The library exists and is newer than its source and than every
    shared header of ``csrc/`` (a changed ``.cuh`` rebuilds its users)."""
    src, lib = _paths(name)
    return newer(lib, [src, *CSRC.glob("*.cuh")])


def compile_all(jobs: Dict[str, tuple]) -> Dict[str, str]:
    """Run every job ``name -> (command, source, library)`` at once, each
    writing a temporary file of its own (``{out}`` in the command) that
    replaces the library when it succeeds, so that concurrent processes can
    build the same library. Returns each compiler's output; raises with it
    on any failure."""
    procs = {}
    for name, (cmd, src, lib) in jobs.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [str(tmp) if a == "{out}" else a for a in cmd]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]} could not be started for {src.name}: {e}") from e
        procs[name] = (proc, cmd[0], src, tmp, lib)
    reports = {}
    for name, (proc, compiler, src, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed for {src.name}:\n{out}")
        os.replace(tmp, lib)
        reports[name] = out
    return reports


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that need it, one ``nvcc`` each, all
    started together. Returns the compiler's ``-Xptxas -v`` report per
    compiled name; raises with the compiler output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        if not _fresh(name):
            src, lib = _paths(name)
            jobs[name] = ([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", "{out}", str(src)],
                          src, lib)
    return compile_all(jobs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            if not _fresh(name):
                build([name])
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]

