"""Host-side collation helpers (numpy; counterpart of ofasys_tpu/preprocessor/utils.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def collate_tokens(
    sequences: Sequence[np.ndarray],
    pad_idx: int,
    eos_idx: Optional[int] = None,
    left_pad: bool = False,
    move_eos_to_beginning: bool = False,
    pad_to_length: Optional[int] = None,
    pad_to_multiple: int = 1,
) -> np.ndarray:
    """Pad a list of 1-D int arrays into (B, T). A pad_to_multiple of 8
    keeps the number of distinct batch shapes small."""
    size = max((len(s) for s in sequences), default=0)
    if pad_to_length is not None:
        size = max(size, pad_to_length)
    if pad_to_multiple > 1 and size % pad_to_multiple != 0:
        size = ((size + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    out = np.full((len(sequences), size), pad_idx, dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq, dtype=np.int32)
        if move_eos_to_beginning:
            if eos_idx is None:
                raise ValueError("move_eos_to_beginning needs eos_idx")
            shifted = np.empty_like(seq)
            if len(seq):
                if seq[-1] != eos_idx:
                    raise ValueError("move_eos_to_beginning: sequence does not end in eos")
                shifted[0] = eos_idx
                shifted[1:] = seq[:-1]
            seq = shifted
        if left_pad:
            out[i, size - len(seq):] = seq
        else:
            out[i, :len(seq)] = seq
    return out


def collate_arrays(
    arrays: Sequence[np.ndarray],
    pad_value: float = 0.0,
    pad_to_multiple: int = 1,
    pad_to_length: Optional[int] = None,
) -> np.ndarray:
    """Pad a list of (T, ...) float arrays along dim 0 into (B, T, ...)."""
    size = max(a.shape[0] for a in arrays)
    if pad_to_length is not None:
        size = max(size, pad_to_length)
    if pad_to_multiple > 1 and size % pad_to_multiple != 0:
        size = ((size + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    rest = arrays[0].shape[1:]
    out = np.full((len(arrays), size) + rest, pad_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out
