"""The port's native line index (ofasys_torch/csrc/host/line_locate.cpp,
called through ctypes) against its numpy scan and ofasys_tpu's.

On edge files (empty, one line without a newline, CRLF ends, a run of
blank lines, a long line) and a seeded 50,000-line TSV, the native index
file, the numpy scan's and ofasys_tpu's ``build_line_index(...,
use_native=False)`` cache file are the same bytes, and ``FileLineReader``
returns the same records either way.
"""

import os

import numpy as np
import pytest

from ofasys_tpu.io.reader import file_reader as jfr
from ofasys_torch.io.reader import file_reader as tfr


def _tsv(rng, n_lines):
    words = ["alpha", "beta", "gamma", "δέλτα", "東京", "x", ""]
    rows = []
    for _ in range(n_lines):
        cols = [" ".join(rng.choice(words, size=rng.integers(0, 8))) for _ in range(rng.integers(1, 4))]
        rows.append("\t".join(cols))
    return ("\n".join(rows) + "\n").encode("utf-8")


FILES = {
    "empty": lambda rng: b"",
    "one_line_no_newline": lambda rng: "one line, no newline at the end".encode(),
    "crlf": lambda rng: b"first\tline\r\nsecond\r\n\r\nfourth\r\n",
    "blank_run": lambda rng: b"\n\n\n\nafter four blank lines\n\n\n",
    "long_line": lambda rng: b"short\n" + bytes(rng.integers(32, 127, size=3_000_000, dtype=np.uint8)) + b"\nend",
    "tsv_50k": lambda rng: _tsv(rng, 50_000),
}


@pytest.fixture
def data(request, tmp_path, monkeypatch):
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path / "cache"))
    path = tmp_path / f"{request.param}.tsv"
    path.write_bytes(FILES[request.param](np.random.default_rng(0)))
    return str(path)


@pytest.mark.parametrize("data", sorted(FILES), indirect=True)
def test_native_index_is_the_numpy_scan_and_ofasys_tpus(data, tmp_path):
    tfr._build_index_native(data, str(tmp_path / "native.idx"))
    tfr._build_index_numpy(data, str(tmp_path / "numpy.idx"))
    jfr.build_line_index(data, use_native=False)
    native = (tmp_path / "native.idx").read_bytes()
    assert native == (tmp_path / "numpy.idx").read_bytes()
    with open(jfr._cache_path(data), "rb") as f:
        assert native == f.read()
    raw = np.frombuffer(native, dtype="<u8")
    assert raw[-1] == os.path.getsize(data) and len(raw) == int(raw[0]) + 2


@pytest.mark.parametrize("data", sorted(FILES), indirect=True)
def test_file_line_reader_same_records_either_way(data, tmp_path, monkeypatch):
    """Each reader builds its own index (the native one, then the numpy
    scan after the cached index is removed, then ofasys_tpu's in a cache of
    its own) and reads every record the same."""
    native = tfr.FileLineReader(data).open()
    assert native.use_native
    os.remove(tfr._cache_path(data))
    plain = tfr.FileLineReader(data, use_native=False).open()
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path / "jax_cache"))
    ref = jfr.FileLineReader(data, use_native=False).open()
    try:
        np.testing.assert_array_equal(native._offsets, plain._offsets)
        np.testing.assert_array_equal(native._offsets, ref._offsets)
        assert len(native) == len(plain) == len(ref)
        for i in range(len(ref)):
            assert native.read(i) == plain.read(i) == ref.read(i)
    finally:
        for r in (native, plain, ref):
            r.close()


def test_failed_native_index_raises(tmp_path):
    with pytest.raises(OSError):
        tfr._build_index_native(str(tmp_path / "missing.tsv"), str(tmp_path / "out.idx"))
    assert os.listdir(tmp_path) == []
