"""Composite readers: TSV columns, in-memory cache, concat, ratio mixing,
HF datasets, lists (counterpart of ofasys_tpu/io/reader/readers.py; the
same shuffles from the same seeds)."""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ofasys_torch.io.reader.base_reader import BaseReader
from ofasys_torch.io.reader.file_reader import FileLineReader


class TsvReader(BaseReader):
    """Column select/alias over a line reader. ``selected_cols`` is the
    '0:src,1:tgt' or 'src,tgt' DSL."""

    def __init__(self, path_or_reader, selected_cols: Optional[str] = None, separator: str = "\t"):
        self.inner = (
            path_or_reader if isinstance(path_or_reader, BaseReader) else FileLineReader(path_or_reader)
        )
        self.separator = separator
        self.col_ids: Optional[List[int]] = None
        self.col_names: Optional[List[str]] = None
        if selected_cols:
            ids, names = [], []
            for i, part in enumerate(selected_cols.split(",")):
                if ":" in part:
                    idx, name = part.split(":", 1)
                    ids.append(int(idx))
                else:
                    name = part
                    ids.append(i)
                names.append(name.strip())
            self.col_ids, self.col_names = ids, names

    def open(self):
        self.inner.open()
        return self

    def close(self):
        self.inner.close()

    def __len__(self):
        return len(self.inner)

    def read(self, index: int) -> Dict[str, str]:
        cols = self.inner.read(index).split(self.separator)
        if self.col_ids is None:
            return {str(i): c for i, c in enumerate(cols)}
        return {name: cols[i] for i, name in zip(self.col_ids, self.col_names)}


class CachedReader(BaseReader):
    """Materializes the inner reader in memory; reshuffles per epoch."""

    def __init__(self, inner: BaseReader, shuffle: bool = True, seed: int = 1):
        self.inner = inner
        self.shuffle = shuffle
        self.seed = seed
        self._data: Optional[List[Any]] = None
        self._order: Optional[np.ndarray] = None

    def open(self):
        if self._data is None:
            self.inner.open()
            self._data = [self.inner.read(i) for i in range(len(self.inner))]
            self.inner.close()
            self._order = np.arange(len(self._data))
        return self

    def reset(self, epoch: int = 0):
        if self._data is None:
            self.open()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            self._order = rng.permutation(len(self._data))

    def __len__(self):
        if self._data is None:
            self.open()
        return len(self._data)

    def read(self, index: int):
        if self._data is None:
            self.open()
        return self._data[self._order[index]]


class ConcatReader(BaseReader):
    def __init__(self, readers: Sequence[BaseReader]):
        self.readers = list(readers)
        self._sizes: Optional[List[int]] = None

    def open(self):
        for r in self.readers:
            r.open()
        self._sizes = [len(r) for r in self.readers]
        return self

    def close(self):
        for r in self.readers:
            r.close()

    def reset(self, epoch: int = 0):
        for r in self.readers:
            r.reset(epoch)

    def __len__(self):
        if self._sizes is None:
            self.open()
        return sum(self._sizes)

    def read(self, index: int):
        if self._sizes is None:
            self.open()
        for r, n in zip(self.readers, self._sizes):
            if index < n:
                return r.read(index)
            index -= n
        raise IndexError(index)


class MixedReader(BaseReader):
    """Ratio-based interleaving of readers: an epoch covers
    sum(ratio_i * len_i) records, sampled deterministically."""

    def __init__(self, readers: Sequence[BaseReader], ratios: Optional[Sequence[float]] = None, seed: int = 1):
        self.readers = list(readers)
        self.ratios = list(ratios) if ratios else [1.0] * len(self.readers)
        self.seed = seed
        self._plan: Optional[List] = None

    def open(self):
        for r in self.readers:
            r.open()
        self._build_plan(0)
        return self

    def _build_plan(self, epoch: int):
        rng = random.Random(self.seed + epoch)
        plan = []
        for ri, (r, ratio) in enumerate(zip(self.readers, self.ratios)):
            n = int(len(r) * ratio)
            idxs = list(range(len(r)))
            rng.shuffle(idxs)
            reps = [idxs[i % len(idxs)] for i in range(n)] if idxs else []
            plan.extend((ri, j) for j in reps)
        rng.shuffle(plan)
        self._plan = plan

    def reset(self, epoch: int = 0):
        for r in self.readers:
            r.reset(epoch)
        self._build_plan(epoch)

    def close(self):
        for r in self.readers:
            r.close()

    def __len__(self):
        if self._plan is None:
            self.open()
        return len(self._plan)

    def read(self, index: int):
        if self._plan is None:
            self.open()
        ri, j = self._plan[index]
        return self.readers[ri].read(j)


class HfDatasetReader(BaseReader):
    """Wraps a huggingface ``datasets.Dataset`` (or any sequence of dict records)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def read(self, index: int) -> Dict[str, Any]:
        return dict(self.dataset[int(index)])


class ListReader(BaseReader):
    """In-memory list of dict records (tests, tiny datasets, Python API)."""

    def __init__(self, records: List[Dict[str, Any]]):
        self.records = records

    def __len__(self):
        return len(self.records)

    def read(self, index: int):
        return self.records[index]
