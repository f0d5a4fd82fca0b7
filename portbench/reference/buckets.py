"""Relative-position buckets of the published OFA (its text adaptor's
log-spaced 1-D buckets and its image adaptor's 2-D buckets with a CLS row),
worked out again for the reference."""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=8)
def _token_buckets(bucket_size: int, max_position: int) -> np.ndarray:
    ctx = np.arange(max_position, dtype=np.int64)[:, None]
    mem = np.arange(max_position, dtype=np.int64)[None, :]
    rel = ctx - mem
    mid = bucket_size // 2
    sign = np.sign(rel)
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    with np.errstate(divide="ignore"):
        log_pos = np.ceil(np.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1)) + mid
    bucket = np.where(abs_pos <= mid, rel, log_pos.astype(np.int64) * sign)
    return bucket + bucket_size - 1


def token_bucket(bucket_size: int, max_position: int, length: int) -> np.ndarray:
    """(length, length) bucket ids into a table of 2 * bucket_size - 1 rows."""
    return _token_buckets(bucket_size, max_position)[:length, :length]


@functools.lru_cache(maxsize=4)
def _image_buckets(bucket_size: int) -> np.ndarray:
    n_rel = (2 * bucket_size - 1) ** 2 + 3
    coords = np.stack(np.meshgrid(np.arange(bucket_size), np.arange(bucket_size), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel += bucket_size - 1
    rel[:, :, 0] *= 2 * bucket_size - 1
    hw = bucket_size * bucket_size
    idx = np.zeros((hw + 1, hw + 1), dtype=np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, :] = n_rel - 3
    idx[:, 0] = n_rel - 2
    idx[0, 0] = n_rel - 1
    return idx


def grid_positions(h: int, w: int, bucket_size: int) -> np.ndarray:
    """Row-major positions of an h x w grid in the bucket_size-wide table,
    after its CLS row."""
    return (np.arange(w)[None, :] + np.arange(h)[:, None] * bucket_size + 1).reshape(-1)


def image_bucket(h: int, w: int, bucket_size: int) -> np.ndarray:
    ids = grid_positions(h, w, bucket_size)
    return _image_buckets(bucket_size)[np.ix_(ids, ids)]
