"""Random-access record reader API (counterpart of
ofasys_tpu/io/reader/base_reader.py)."""

from __future__ import annotations

from typing import Any


class BaseReader:
    """open/seek/read/close/__len__ over integer-indexed records."""

    def open(self):
        return self

    def close(self):
        pass

    def __len__(self) -> int:
        raise NotImplementedError

    def read(self, index: int) -> Any:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Any:
        return self.read(index)

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()

    def reset(self, epoch: int = 0):
        """Hook for epoch-dependent behavior (shuffle, path rotation)."""
