"""Pre-build the line indexes of TSV datasets (counterpart of
ofasys_tpu/tools/create_tsv_cache.py), so data-loading workers never race on
an index build:

    python -m ofasys_torch.tools.create_tsv_cache a.tsv b.tsv ...

Each index is ``FileLineReader``'s, cached under ``$OFA_CACHE_HOME``.
"""

import sys

from ofasys_torch.io.reader.file_reader import build_line_index


def main(paths):
    for p in paths:
        offsets = build_line_index(p)
        print(f"{p}: {len(offsets) - 1} lines indexed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
