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


# every kernel source that includes a shared header, directly or through
# another header, and that header
INCLUDES = [("flash_attention_fwd", "dense_mma.cuh"), ("dense_attention_fwd", "dense_mma.cuh"),
            ("dense_attention_bwd", "dense_attention_bwd_mma.cuh"),
            ("dense_attention_bwd", "dense_mma.cuh"),
            ("dense_attention_bwd_rowmajor", "dense_attention_bwd_mma.cuh"),
            ("dense_attention_bwd_rowmajor", "dense_mma.cuh"),
            ("flash_attention_bwd", "dense_attention_bwd_mma.cuh"),
            ("flash_attention_bwd", "dense_mma.cuh"), ("int8_matmul", "dense_mma.cuh")]


@pytest.mark.parametrize("name,header", INCLUDES, ids=[f"{n}-{h}" for n, h in INCLUDES])
def test_a_newer_included_header_rebuilds_its_kernel(tmp_path, monkeypatch, name, header):
    """The kernel's source includes the header (here or through another
    header of csrc/), and a library older than that header is rebuilt."""
    real = cuda_build.CSRC

    def included(path, seen=()):
        text = path.read_text()
        direct = {h for h in (p.name for p in real.glob("*.cuh")) if f'#include "{h}"' in text}
        return direct.union(*(included(real / h, seen + (h,)) for h in direct if h not in seen))

    assert header in included(real / f"{name}.cu")
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    for path in [real / f"{name}.cu", *real.glob("*.cuh")]:
        (csrc / path.name).write_text(path.read_text())
        _touch(csrc / path.name, 1000)
    lib = build / f"lib{name}.so"
    lib.write_bytes(b"")
    _touch(lib, 2000)
    assert cuda_build._fresh(name)
    _touch(csrc / header, 3000)
    assert not cuda_build._fresh(name)
