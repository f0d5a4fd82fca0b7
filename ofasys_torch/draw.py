"""Training-log plotting (counterpart of ofasys_tpu/draw.py): parse the json
and simple progress lines of a log file and plot loss, lr and gnorm curves
with matplotlib.

Usage: python -m ofasys_torch.draw train.log out.png [keys...]
"""

from __future__ import annotations

import json
import re
import sys
from collections import defaultdict
from typing import Dict, List

_KV = re.compile(r"(\S+) ([-+0-9.e]+)")


def parse_log(path: str) -> Dict[str, List[float]]:
    """Each numeric key of the log's json lines and ``key value | ...``
    lines, as a series in line order."""
    series: Dict[str, List[float]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            obj = None
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    obj = None
            if obj is None and "|" in line:
                obj = {}
                for part in line.split("|"):
                    m = _KV.match(part.strip())
                    if m:
                        try:
                            obj[m.group(1)] = float(m.group(2))
                        except ValueError:
                            pass
            if obj:
                for k, v in obj.items():
                    if isinstance(v, (int, float)):
                        series[k].append(float(v))
    return dict(series)


def draw(log_path: str, out_path: str, keys: List[str] = ()):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = parse_log(log_path)
    keys = list(keys) or [k for k in series if any(t in k for t in ("loss", "lr", "gnorm"))]
    n = max(len(keys), 1)
    fig, axes = plt.subplots(n, 1, figsize=(8, 3 * n), squeeze=False)
    for ax, key in zip(axes[:, 0], keys):
        ax.plot(series.get(key, []))
        ax.set_title(key)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path)
    return out_path


if __name__ == "__main__":
    draw(sys.argv[1], sys.argv[2], sys.argv[3:])
