"""Build the ``__list_object__.txt`` manifest of an object-store "directory"
(counterpart of ofasys_tpu/tools/create_oss_list_objects.py): a task whose
train_data is ``oss://bucket/dir/`` reads this manifest to find its shards.

The lister is pluggable: ``ossutil64``/``ossutil`` when one is on PATH, else
a ``list_fn(path) -> lines`` callable passed in (another object store, or a
test). Uploading the manifest takes a ``put_fn(local, remote)`` likewise.

    python -m ofasys_torch.tools.create_oss_list_objects oss://bucket/dir/
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Callable, List, Optional

MANIFEST = "__list_object__.txt"


def _ossutil() -> Optional[str]:
    return shutil.which("ossutil64") or shutil.which("ossutil")


def _ossutil_list(path: str) -> List[str]:
    exe = _ossutil()
    if exe is None:
        raise RuntimeError("no ossutil/ossutil64 on PATH — pass list_fn= or install the CLI")
    return subprocess.check_output([exe, "ls", path, "-s"], text=True).splitlines()


def list_objects(path: str, list_fn: Optional[Callable[[str], List[str]]] = None) -> List[str]:
    """The object URLs under ``path`` (an oss:// directory ending in '/'),
    without sub-directories and ``__``-prefixed bookkeeping objects."""
    if not (path.startswith("oss://") and path.endswith("/")):
        raise ValueError("oss path must be an explicit directory (oss://.../)")
    keep = []
    for line in (list_fn or _ossutil_list)(path):
        line = line.strip()
        if not line.startswith(path) or line.endswith("/"):
            continue
        if os.path.basename(line).startswith("__"):
            continue
        keep.append(line)
    return keep


def write_manifest(path: str, out_dir: str = ".",
                   list_fn: Optional[Callable[[str], List[str]]] = None,
                   put_fn: Optional[Callable[[str, str], None]] = None) -> str:
    """Write the manifest to ``out_dir`` and upload it beside the listed
    objects through ``put_fn`` (or ossutil, when one is on PATH)."""
    objs = list_objects(path, list_fn=list_fn)
    local = os.path.join(out_dir, MANIFEST)
    with open(local, "w", encoding="utf-8") as f:
        for o in objs:
            print(o, file=f)
    remote = path + MANIFEST
    if put_fn is not None:
        put_fn(local, remote)
    elif _ossutil() is not None:
        subprocess.check_call([_ossutil(), "cp", "-f", local, remote])
    return local


def main(argv):
    if len(argv) != 1:
        print(__doc__)
        return 2
    local = write_manifest(argv[0])
    with open(local, encoding="utf-8") as f:
        n = sum(1 for _ in f)
    print(f"{local}: {n} objects listed under {argv[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
