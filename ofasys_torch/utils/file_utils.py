"""File and cache utilities (counterpart of ofasys_tpu/utils/file_utils.py),
for local paths and ``file://`` URLs.

``cached_path`` resolves a local path or a ``file://`` URL; a remote scheme
(http, https, oss, ...) raises: remote and object-store sources are not
ported (ROADMAP Queue A item 11). ``local_file_lock`` is the flock-based
cross-process lock around index building and cache writes.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from typing import Optional

REMOTE = ("ROADMAP Queue A item 11: remote and object-store sources are not ported to "
          "ofasys_torch; use a local path or a file:// URL")


def cache_home() -> str:
    """``$OFA_CACHE_HOME``, default ``~/.cache/ofasys_torch`` (created)."""
    home = os.environ.get("OFA_CACHE_HOME", os.path.expanduser("~/.cache/ofasys_torch"))
    os.makedirs(home, exist_ok=True)
    return home


@contextlib.contextmanager
def local_file_lock(path: str):
    """An exclusive flock on ``path`` for the duration of the block."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def local_path(url_or_path: str) -> str:
    """``url_or_path`` without its ``file://`` scheme; a remote scheme raises."""
    if url_or_path.startswith("file://"):
        return url_or_path[len("file://"):]
    if "://" in url_or_path and not os.path.exists(url_or_path):
        raise NotImplementedError(f"{url_or_path}: {REMOTE}")
    return url_or_path


def cached_path(url_or_path: str, cache_dir: Optional[str] = None) -> str:
    """A local filesystem path for ``url_or_path`` (``cache_dir`` is
    ofasys_tpu's download cache, unused for local sources)."""
    path = local_path(url_or_path)
    if not os.path.exists(path):
        raise FileNotFoundError(url_or_path)
    return path
