"""What every cell shares: finding the cell's pieces by name, the run's
set-up phases, the per-layer readers, the device record and the result
line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is the file that the ``configs`` entry of its name gives
(``portbench/configs/<name>.json``), its traffic mix
``portbench/traffic/<traffic>.json``, whose ``kind`` picks the code that
runs it (``portbench/kinds/<kind>.py``), and each per-layer metric it reports is
read by ``portbench/metrics/<metric>.py``'s ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ofasys_tpu")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: Dict, cell: Dict, root: str = ROOT) -> Dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return load_json(os.path.join(root, entry["file"]))


def traffic_of(cell: Dict, root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json"))


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_of(kind: str, root: str = ROOT):
    return _load_file(os.path.join(root, "portbench", "kinds", kind + ".py"), f"portbench_kind_{kind}")


def cell_metrics(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of this cell prints: its end-to-end metrics (those
    that list it, and those with no list, as ``setup_s``), or with ``trace``
    the per-layer metrics that list it."""
    name = cell["name"]
    if trace:
        return [m for m in bench["per_layer"] if name in m["workloads"]]
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def read_per_layer(metrics: List[Dict], ctx: Dict, root: str = ROOT) -> Dict[str, Dict]:
    """Each metric's reader on the run's context; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = _load_file(os.path.join(root, "portbench", "metrics", m["name"] + ".py"),
                            "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)} & set(FORBIDDEN))


def cache_env(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc libraries already live in ``ofasys_torch/_build``)."""
    base = os.path.join(root, "portbench", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


class Phases:
    """Named set-up phases on the host clock from the run's start."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.last = t0
        self.rows: List[tuple] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.rows.append((name, now - self.last))
        self.last = now

    def line(self) -> str:
        return "setup phases (s): " + ", ".join(f"{n} {s:.3f}" for n, s in self.rows)


def device_record(device, peak_bytes: int, count: int = 1) -> Dict[str, Any]:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def profile(device):
    """A profiler of the host and, on a card, of the device."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def trace_window(prof, tmpdir: str) -> Dict:
    """The profiled sub-window between the harness's marks, read by the
    frozen reader; the trace file is deleted after reading."""
    from portbench import trace

    path = os.path.join(tmpdir, f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        return trace.read(path, "portbench_open", "portbench_close")
    finally:
        os.remove(path)


def emit(result: Dict, compared: Dict[str, Dict], log: Callable[[str], None]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line of standard output,
    with the compared numbers under its last key."""
    for name, c in compared.items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    result = dict(result)
    result["compared"] = compared
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
