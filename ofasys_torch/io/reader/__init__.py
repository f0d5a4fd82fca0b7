from ofasys_torch.io.reader.base_reader import BaseReader
from ofasys_torch.io.reader.dataset import EpochBatchIterator, parse_dataset_paths
from ofasys_torch.io.reader.file_reader import FileLineReader, build_line_index
from ofasys_torch.io.reader.readers import (
    CachedReader,
    ConcatReader,
    HfDatasetReader,
    ListReader,
    MixedReader,
    TsvReader,
)

__all__ = [
    "BaseReader", "FileLineReader", "build_line_index", "TsvReader", "CachedReader",
    "ConcatReader", "MixedReader", "HfDatasetReader", "ListReader",
    "EpochBatchIterator", "parse_dataset_paths",
]
