"""The benchmark's reader of a torch.profiler Chrome trace.

A frozen copy of the reader in ``ofasys_torch/tools/profile_breakdown.py``
(device events by kind, busy time as the union of their intervals, the
longest idle gaps with the host event active on the launching thread). It
lives here so that a change to the program cannot change how the benchmark
reads its trace.
"""

from __future__ import annotations

import bisect
import collections
import functools
import json
import re
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# the port's kernels by id, keyed by the function name of their device symbol
PORT_SYMBOLS = {
    "dense_attention_fwd_mma_kernel": "B1", "dense_attention_fwd_kernel": "B1",
    "bwd_rows_kernel": "B2", "bwd_cols_kernel": "B2",
    "bwd_rowmajor_kernel": "B2r",
    "flash_fwd_mma_kernel": "B3",
    "ln_fwd_kernel": "B6", "ln_fwd_rows_kernel": "B6", "ln_bwd_kernel": "B6",
    "ln_bwd_rows_kernel": "B6", "ln_bwd_reduce_kernel": "B6",
    "int8_mma_kernel": "B7", "int8_dp4a_kernel": "B7",
}
PORT_IDS = ("B1", "B2", "B2r", "B3", "flash-bwd", "B6", "B7")
SHARED_REDUCTION = "attention-bwd reduction"
# a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 200
_SYMBOL = re.compile(r"([A-Za-z_]\w*)[<(]")
_GEMM = ("gemm", "gemv", "cutlass", "xmma", "sm90_", "nvjet", "cublas")
_COPY = ("copy_kernel", "catarraybatchedcopy", "fillfunctor", "memcpy", "memset")
_REDUCTION = ("reduce_kernel", "softmax", "layer_norm", "gammabeta", "nll_loss", "cross_entropy",
              "norm_kernel", "scan_", "cumsum", "argmax", "topk", "sort")
_ELEMENTWISE = ("elementwise", "multi_tensor_apply", "dropout")


def symbol(name: str) -> str:
    m = _SYMBOL.search(name)
    return m.group(1) if m else name


@functools.lru_cache(maxsize=4096)
def classify(name: str, cat: str = "kernel") -> str:
    """One kind per device event: a port kernel's id, 'gemm', 'copy/set',
    'reduction', 'elementwise' or 'other'."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/set"
    sym = symbol(name)
    if sym == "bwd_mma_kernel":
        args = name.split("bwd_mma_kernel<", 1)[1].split(">", 1)[0]
        causal, flash = (a.strip() in ("true", "(bool)1", "1") for a in args.split(","))
        return "flash-bwd" if flash else "B2r" if causal else "B2"
    if sym in ("dq_reduce_kernel", "dbias_reduce_kernel"):
        return SHARED_REDUCTION if "dense_bwd_mma::" in name else "B2r"
    if sym in PORT_SYMBOLS:
        return PORT_SYMBOLS[sym]
    low = name.lower()
    for kind, keys in (("gemm", _GEMM), ("copy/set", _COPY), ("reduction", _REDUCTION),
                       ("elementwise", _ELEMENTWISE)):
        if any(k in low for k in keys):
            return kind
    return "other"


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def complete_events(trace: dict) -> List[dict]:
    return [e for e in trace["traceEvents"] if e.get("ph") == "X" and "ts" in e]


def load_ops(events: List[dict]) -> List[dict]:
    """The device events in start order (µs), each with its kind and the
    launch it is correlated with."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = []
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"]):
        launch = launches.get(e.get("args", {}).get("correlation"))
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        ops.append(dict(name=e["name"], cat=e["cat"], kind=classify(e["name"], e["cat"]), ts=ts,
                        dur=dur, end=ts + dur, stream=(e.get("pid"), e.get("tid")),
                        launch_tid=None if launch is None else launch.get("tid")))
    last = {}
    for op in ops:
        if op["kind"] == SHARED_REDUCTION:
            op["kind"] = last.get(op["stream"], SHARED_REDUCTION)
        elif op["kind"] in PORT_IDS:
            last[op["stream"]] = op["kind"]
    return ops


class HostIndex:
    """Host events of each thread with their parents, to name the innermost
    host event active at a time."""

    def __init__(self, events: List[dict]):
        self.threads: Dict[object, dict] = {}
        by_tid = collections.defaultdict(list)
        for e in events:
            by_tid[e.get("tid")].append(e)
        for tid, evs in by_tid.items():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
            parents, stack = [], []
            for i, e in enumerate(evs):
                while stack and evs[stack[-1]]["ts"] + evs[stack[-1]].get("dur", 0.0) <= e["ts"]:
                    stack.pop()
                parents.append(stack[-1] if stack else -1)
                stack.append(i)
            self.threads[tid] = dict(events=evs, starts=[e["ts"] for e in evs], parents=parents)

    def innermost(self, tid, t: float) -> Optional[str]:
        th = self.threads.get(tid)
        if th is None:
            return None
        i = bisect.bisect_right(th["starts"], t) - 1
        while i >= 0:
            e = th["events"][i]
            if e["ts"] <= t < e["ts"] + e.get("dur", 0.0):
                return e["name"]
            i = th["parents"][i]
        return None


def window(ops: List[dict], host: HostIndex, main_tid, lo: float, hi: float,
           n_top: int = 10) -> dict:
    """Busy (the union of the device events' intervals), the idle share,
    kernel launches, device seconds by name and the longest idle gaps,
    each named by the host event active where it starts, over [lo, hi] µs."""
    inside = [op for op in ops if op["end"] > lo and op["ts"] < hi]
    busy, gaps, cur = 0.0, [], lo
    for op in inside:
        s, f = max(op["ts"], lo), min(op["end"], hi)
        if s > cur:
            gaps.append((s - cur, cur, op))
        if f > max(s, cur):
            busy += f - max(s, cur)
        cur = max(cur, f)
    if hi > cur:
        gaps.append((hi - cur, cur, None))
    by_name: Dict[str, float] = collections.defaultdict(float)
    for op in inside:
        by_name[op["name"]] += op["dur"] / 1e6
    named_gaps = []
    for dur, start, after in sorted(gaps, key=lambda g: -g[0])[:n_top]:
        tid = after["launch_tid"] if after is not None and after["launch_tid"] is not None else main_tid
        named_gaps.append([host.innermost(tid, start) or "none", dur / 1e6])
    wall = hi - lo
    return dict(
        wall_s=wall / 1e6, busy_s=busy / 1e6,
        idle=(1.0 - busy / wall) if inside and wall > 0 else None,
        launches=sum(op["cat"] == "kernel" for op in inside),
        ops=inside,
        device_ops=sorted(([n[:NAME_CHARS], s] for n, s in by_name.items()), key=lambda x: -x[1])[:n_top],
        idle_gaps=named_gaps)


def read(path: str, lo_name: str, hi_name: str) -> dict:
    """The window between the end of the host range named ``lo_name`` and
    the start of the one named ``hi_name`` (the harness's marks around its
    profiled sub-window), read as :func:`window` does."""
    events = complete_events(load(path))
    ops = load_ops(events)
    host_events = [e for e in events if e.get("cat") in HOST_CATS]
    marks = {e["name"]: e for e in host_events if e.get("cat") == "user_annotation"}
    if lo_name not in marks or hi_name not in marks:
        raise ValueError(f"trace has no marks {lo_name!r} and {hi_name!r}")
    lo = float(marks[lo_name]["ts"]) + float(marks[lo_name].get("dur", 0.0))
    hi = float(marks[hi_name]["ts"])
    tids = collections.Counter(op["launch_tid"] for op in ops if op["launch_tid"] is not None)
    main_tid = tids.most_common(1)[0][0] if tids else None
    return window(ops, HostIndex(host_events), main_tid, lo, hi)
