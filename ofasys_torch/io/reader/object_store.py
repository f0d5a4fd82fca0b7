"""Object-store readers behind the BaseReader API (counterpart of
ofasys_tpu/io/reader/object_store.py).

Remote objects resolve through ``cached_path``'s scheme fetchers
(utils/file_utils.py: register oss://, or any scheme, at run time), or
through a ``fetcher`` passed in; the ODPS reader takes its client the same
way. Nothing here needs an SDK or the network."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ofasys_torch.io.reader.base_reader import BaseReader
from ofasys_torch.utils.file_utils import cached_path


def _fetch(url: str, fetcher: Optional[Callable[[str], str]]) -> str:
    return fetcher(url) if fetcher is not None else cached_path(url)


class ObjectStoreLineReader(BaseReader):
    """Random-access lines of a remote text object (oss://..., http://...):
    fetched once into the local cache, its lines held in memory."""

    def __init__(self, url: str, fetcher: Optional[Callable[[str], str]] = None):
        self.url = url
        self._fetch = fetcher
        self._lines: Optional[List[str]] = None

    def open(self):
        if self._lines is None:
            with open(_fetch(self.url, self._fetch), encoding="utf-8") as f:
                self._lines = [ln.rstrip("\n") for ln in f]
        return self

    def __len__(self):
        self.open()
        return len(self._lines)

    def read(self, index: int):
        self.open()
        return self._lines[index]

    def iter_lines(self, open_stream: Callable[[str], Any],
                   chunk_bytes: int = 1 << 16, max_chunks: int = 16):
        """Stream the object's lines without holding it whole:
        ``open_stream(url)`` returns a file-like with ``read(n)`` (an
        object-store body, an http response, a local file). Yields decoded
        lines in order; the stream is closed on any exit, an early break
        included, so its prefetch thread never blocks on a full queue."""
        from ofasys_torch.io.reader.streaming import StreamingLineReader

        src = open_stream(self.url)
        with StreamingLineReader(src, chunk_bytes=chunk_bytes, max_chunks=max_chunks) as reader:
            for raw in reader:
                yield raw.decode("utf-8")


class OssTextBinReader(BaseReader):
    """Fixed-length token blocks for LM pretraining: the object is a flat
    array of ``dtype`` token ids, and record i is ids
    ``[i * block_tokens, (i + 1) * block_tokens)`` (a short tail is
    dropped)."""

    def __init__(self, url: str, block_tokens: int = 512, dtype: str = "int32",
                 fetcher: Optional[Callable[[str], str]] = None):
        self.url = url
        self.block = block_tokens
        self.dtype = dtype
        self._fetch = fetcher
        self._data: Optional[np.ndarray] = None

    def open(self):
        if self._data is None:
            self._data = np.fromfile(_fetch(self.url, self._fetch), dtype=self.dtype)
        return self

    def __len__(self):
        self.open()
        return len(self._data) // self.block

    def read(self, index: int):
        self.open()
        return self._data[index * self.block:(index + 1) * self.block]


class OdpsReader(BaseReader):
    """ODPS table reader over an injected client exposing ``count()`` and
    ``read(index) -> dict`` (the ODPS SDK is not bundled)."""

    def __init__(self, table: str, client: Any = None,
                 selected_cols: Optional[Sequence[str]] = None):
        if client is None:
            raise ImportError("OdpsReader needs an ODPS client (common-io is not bundled); "
                              "pass client= explicitly or install the SDK")
        self.table = table
        self.client = client
        self.selected_cols = list(selected_cols) if selected_cols else None

    def __len__(self):
        return int(self.client.count())

    def read(self, index: int) -> Dict[str, Any]:
        row = self.client.read(index)
        if self.selected_cols:
            return {k: row[k] for k in self.selected_cols}
        return dict(row)
