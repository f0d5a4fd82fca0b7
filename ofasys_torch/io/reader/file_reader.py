"""Line-indexed local file reader (counterpart of
ofasys_tpu/io/reader/file_reader.py).

Random access into large text/TSV files through a newline-offset index,
built by the C++ scanner ``csrc/host/line_locate.cpp`` (``use_native``,
the default; built with the host's C++ compiler at first use) or a numpy
scan, and cached under ``$OFA_CACHE_HOME`` (default
``~/.cache/ofasys_torch``) behind a flock, so concurrent readers build it
once. Both write the same bytes, ofasys_tpu's format: uint64 line count,
the line start offsets, the file size.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
from typing import Optional

import numpy as np

from ofasys_torch.io.reader.base_reader import BaseReader
from ofasys_torch.utils.file_utils import cache_home, local_file_lock, local_path


def _cache_path(path: str) -> str:
    st = os.stat(path)
    key = hashlib.md5(f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}".encode()).hexdigest()
    return os.path.join(cache_home(), f"{os.path.basename(path)}.{key}.idx")


def build_line_index(path: str, use_native: bool = True) -> np.ndarray:
    """int64 offsets of length n_lines + 1 (line i spans
    offsets[i]:offsets[i + 1])."""
    cache = _cache_path(path)
    with local_file_lock(cache + ".lock"):
        if not os.path.exists(cache):
            (_build_index_native if use_native else _build_index_numpy)(path, cache)
        raw = np.fromfile(cache, dtype=np.uint64)
    n = int(raw[0])
    starts = raw[1:1 + n]
    size = raw[1 + n]
    return np.concatenate([starts, [size]]).astype(np.int64)


def _build_index_native(path: str, out: str):
    """The C++ scan (``ofa_line_locate``), written to a temporary name and
    renamed."""
    from ofasys_torch.ops import host_build

    lib = host_build.load("line_locate")
    lib.ofa_line_locate.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ofa_line_locate.restype = ctypes.c_int
    tmp = f"{out}.{os.getpid()}.tmp"
    err = lib.ofa_line_locate(os.fsencode(path), os.fsencode(tmp))
    if err:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise OSError(err, f"line_locate: {os.strerror(err)}", path)
    os.replace(tmp, out)


def _build_index_numpy(path: str, out: str):
    """Vectorized newline scan in 256 MB windows."""
    size = os.path.getsize(path)
    starts = [0] if size > 0 else []
    window = 256 * 1024 * 1024
    with open(path, "rb") as f:
        base = 0
        while base < size:
            chunk = f.read(window)
            if not chunk:
                break
            arr = np.frombuffer(chunk, dtype=np.uint8)
            nls = np.nonzero(arr == 10)[0]
            starts.extend((base + nls + 1).tolist())
            base += len(chunk)
    if starts and starts[-1] == size:
        starts.pop()  # trailing newline: no final empty line
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.asarray([len(starts)], np.uint64).tofile(f)
        np.asarray(starts, np.uint64).tofile(f)
        np.asarray([size], np.uint64).tofile(f)
    os.replace(tmp, out)


class FileLineReader(BaseReader):
    def __init__(self, path: str, use_native: bool = True):
        self.path = local_path(path)
        self.use_native = use_native
        self._offsets: Optional[np.ndarray] = None
        self._mm: Optional[mmap.mmap] = None
        self._fh = None

    def open(self):
        if self._mm is None:
            self._offsets = build_line_index(self.path, self.use_native)
            self._fh = open(self.path, "rb")
            if os.path.getsize(self.path) > 0:
                self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        return self

    def close(self):
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __len__(self):
        if self._offsets is None:
            self.open()
        return max(len(self._offsets) - 1, 0)

    def read(self, index: int) -> str:
        if self._mm is None:
            self.open()
        start, end = int(self._offsets[index]), int(self._offsets[index + 1])
        line = self._mm[start:end]
        return line.rstrip(b"\n").decode("utf-8")
