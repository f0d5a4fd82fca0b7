"""The build cache of ofasys_torch's CUDA kernels (ops/cuda_build.py): a
library is reused only while it is newer than its source and than every
shared header of ``csrc/``. Runs on the CPU: nothing is compiled."""

import os

import pytest

from ofasys_torch.ops import cuda_build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    (csrc / "k.cu").write_text("// source")
    (csrc / "shared.cuh").write_text("// header")
    return csrc, build


def _touch(path, t):
    os.utime(path, (t, t))


def test_missing_library_is_stale(tree):
    assert not cuda_build._fresh("k")


@pytest.mark.parametrize("newer", ["none", "source", "header"])
def test_library_is_fresh_only_while_newer_than_source_and_headers(tree, newer):
    csrc, build = tree
    lib = build / "libk.so"
    lib.write_bytes(b"")
    _touch(csrc / "k.cu", 1000)
    _touch(csrc / "shared.cuh", 1000)
    _touch(lib, 2000)
    if newer != "none":
        _touch(csrc / ("k.cu" if newer == "source" else "shared.cuh"), 3000)
    assert cuda_build._fresh("k") == (newer == "none")
