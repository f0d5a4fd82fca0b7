"""File and cache utilities (counterpart of ofasys_tpu/utils/file_utils.py).

``cached_path`` resolves a local path or a ``file://`` URL as it is, and a
remote URL into ``$OFA_CACHE_HOME``: a scheme with a registered fetcher
(``register_scheme_fetcher('oss', fetch)``) goes through it, ``http(s)``
through ``urllib`` where the host has egress. A fetched file is named
``sha256(url)[:24].<basename>``, written as ``.tmp`` and renamed, under a
flock, with a ``.json`` sidecar naming its URL. ``local_file_lock`` is the
flock-based cross-process lock around index building and cache writes.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil
import urllib.request
from typing import Callable, Dict, Optional

_SCHEME_FETCHERS: Dict[str, Callable[[str, str], None]] = {}


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


def register_scheme_fetcher(scheme: str, fetch: Callable[[str, str], None]):
    """Attach ``fetch(url, local_destination)`` for URLs of ``scheme``
    ('oss', ...); a later registration replaces an earlier one."""
    _SCHEME_FETCHERS[scheme] = fetch


def local_path(url_or_path: str) -> str:
    """``url_or_path`` without its ``file://`` scheme."""
    if url_or_path.startswith("file://"):
        return url_or_path[len("file://"):]
    return url_or_path


def cached_path(url_or_path: str, cache_dir: Optional[str] = None) -> str:
    """A local filesystem path for ``url_or_path``: a local path or a
    ``file://`` URL as it is, a remote URL fetched once into ``cache_dir``
    (default ``cache_home()``)."""
    if os.path.exists(url_or_path):
        return url_or_path
    if url_or_path.startswith("file://"):
        return url_or_path[len("file://"):]
    scheme = url_or_path.split("://", 1)[0] if "://" in url_or_path else ""
    if not scheme:
        raise FileNotFoundError(url_or_path)
    cache = cache_dir or cache_home()
    key = hashlib.sha256(url_or_path.encode()).hexdigest()[:24]
    name = os.path.basename(url_or_path.split("?")[0]) or "file"
    dest = os.path.join(cache, f"{key}.{name}")
    with local_file_lock(dest + ".lock"):
        if os.path.exists(dest):
            return dest
        tmp = dest + ".tmp"
        if scheme in _SCHEME_FETCHERS:
            _SCHEME_FETCHERS[scheme](url_or_path, tmp)
        elif scheme in ("http", "https"):
            with urllib.request.urlopen(url_or_path, timeout=60) as r, open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
        else:
            raise ValueError(f"no fetcher for scheme {scheme!r} ({url_or_path})")
        os.rename(tmp, dest)
        with open(dest + ".json", "w") as f:
            json.dump({"url": url_or_path}, f)
    return dest
