"""Relative position machinery (host-side, numpy; counterpart of
ofasys_tpu/model/positional.py).

Bucket matrices depend only on the sequence length: computed once in numpy
and indexed per layer on the device with a single gather, instead of
materializing B×H×T×T bias tensors per layer.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=32)
def make_token_bucket_position(bucket_size: int, max_position: int) -> np.ndarray:
    """(max_position, max_position) int32 bucket ids for 1-D relative
    positions: identity buckets within ±bucket_size/2, log-spaced beyond
    (same scheme as reference adaptor/text.py:20-31)."""
    ctx = np.arange(max_position, dtype=np.int64)[:, None]
    mem = np.arange(max_position, dtype=np.int64)[None, :]
    rel = ctx - mem
    mid = bucket_size // 2
    sign = np.sign(rel)
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    with np.errstate(divide="ignore"):
        log_pos = (
            np.ceil(np.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)) + mid
        ).astype(np.int64)
    bucket = np.where(abs_pos <= mid, rel, log_pos * sign)
    return (bucket + bucket_size - 1).astype(np.int32)


def token_bucket(bucket_size: int, max_position: int, length: int) -> np.ndarray:
    """(length, length) int32: the token bucket of a sequence's first
    ``length`` positions."""
    return make_token_bucket_position(bucket_size, max_position)[:length, :length]


def token_bucket_count(bucket_size: int) -> int:
    return 2 * bucket_size - 1


@functools.lru_cache(maxsize=8)
def make_image_bucket_position(bucket_size: int, num_relative_distance: int) -> np.ndarray:
    """(hw+1, hw+1) int32 bucket ids for 2-D patch grids plus a leading CLS
    row/col with dedicated buckets (same scheme as reference
    adaptor/image_resnet.py:25-41)."""
    coords = np.stack(np.meshgrid(np.arange(bucket_size), np.arange(bucket_size), indexing="ij"))
    flat = coords.reshape(2, -1)  # 2, HW
    rel = flat[:, :, None] - flat[:, None, :]  # 2, HW, HW
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += bucket_size - 1
    rel[:, :, 1] += bucket_size - 1
    rel[:, :, 0] *= 2 * bucket_size - 1
    hw = bucket_size * bucket_size
    idx = np.zeros((hw + 1, hw + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = num_relative_distance - 3
    idx[:, 0] = num_relative_distance - 2
    idx[0, 0] = num_relative_distance - 1
    return idx.astype(np.int32)


def image_bucket_count(bucket_size: int) -> int:
    return (2 * bucket_size - 1) * (2 * bucket_size - 1) + 3


def block_diag_buckets(slot_buckets, slot_table_sizes) -> np.ndarray:
    """Combine per-slot bucket matrices into one (T,T) matrix indexing a
    *concatenated* bias table.

    Row 0 of the combined table is reserved as the all-zero "no relative
    bias" bucket used for cross-slot (off-block-diagonal) pairs; slot s's
    bucket ids are shifted by 1 + sum(previous table sizes). Negative bucket
    entries (slots without relative bias) also map to the zero bucket. One
    gather per layer then yields the full block-diagonal relative bias.
    """
    total = sum(b.shape[0] for b in slot_buckets)
    out = np.zeros((total, total), dtype=np.int32)
    offset_tok = 0
    offset_tab = 1
    for bucket, tsize in zip(slot_buckets, slot_table_sizes):
        n = bucket.shape[0]
        shifted = np.where(bucket >= 0, bucket + offset_tab, 0)
        out[offset_tok:offset_tok + n, offset_tok:offset_tok + n] = shifted
        offset_tok += n
        offset_tab += tsize
    return out
