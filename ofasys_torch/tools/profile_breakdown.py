"""Summarize a torch.profiler Chrome trace: device time by kind, the idle
share, and what the host was doing in the device's longest idle gaps
(counterpart of ofasys_tpu/tools/profile_breakdown.py, which reads a
jax.profiler xplane).

Reads the ``trace.json`` that ``utils/profiler.profile`` and the trainer's
``common.profile`` write. Device busy time is the union of the device
events' intervals (kernels, copies and sets on every stream), not their
sum; the idle share is one minus busy over the window's wall time. Each
device event is matched to the call that launched it by its CUDA
correlation id. With ``ranges`` (a name prefix such as ``"update "``), each
host range of that name (the trainer's ``update <n>``) gets its own
summary, holding the device events launched inside it.

Usage:
    python -m ofasys_torch.tools.profile_breakdown <dir|trace.json> [top_n] [--ranges PREFIX]

A trace taken on the CPU has no device events: the summary says so and
lists the host's ops.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# the port's kernels (``csrc/*.cu``) by id, keyed by their device symbol's
# function name; bwd_mma_kernel<kCausal, kFlash> is B2 <false, false>, B2r
# <true, false> and the flash backward <*, true>
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
# dense_bwd_mma's dq and dbias reductions, launched by B2, B2r and the flash
# backward after their pass: load_ops gives each the id of the port kernel
# before it on its stream
SHARED_REDUCTION = "attention-bwd reduction"

_SYMBOL = re.compile(r"([A-Za-z_]\w*)[<(]")
_GEMM = ("gemm", "gemv", "cutlass", "xmma", "sm90_", "nvjet", "cublas")
_COPY = ("copy_kernel", "catarraybatchedcopy", "fillfunctor", "memcpy", "memset")
_REDUCTION = ("reduce_kernel", "softmax", "layer_norm", "gammabeta", "nll_loss", "cross_entropy",
              "norm_kernel", "scan_", "cumsum", "argmax", "topk", "sort")
_ELEMENTWISE = ("elementwise", "multi_tensor_apply", "dropout")


def find_trace(path: str) -> str:
    """``path`` itself, or the newest ``*trace.json`` under the directory."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*trace.json"), recursive=True)
    if not hits:
        raise FileNotFoundError(f"no trace.json under {path}")
    return max(hits, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    with open(find_trace(path)) as f:
        return json.load(f)


def symbol(name: str) -> str:
    """The function name of a demangled kernel symbol (``void
    ns::name<T>(args)`` -> ``name``), or the name itself."""
    m = _SYMBOL.search(name)
    return m.group(1) if m else name


@functools.lru_cache(maxsize=4096)
def classify(name: str, cat: str = "kernel") -> str:
    """One kind per device event: a port kernel's id (B1, B2, B2r, B3,
    flash-bwd, B6, B7, or SHARED_REDUCTION), 'gemm', 'copy/set',
    'reduction', 'elementwise' or 'other'."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/set"
    sym = symbol(name)
    if sym == "bwd_mma_kernel":
        args = name.split("bwd_mma_kernel<", 1)[1].split(">", 1)[0]
        causal, flash = (a.strip() in ("true", "(bool)1", "1") for a in args.split(","))
        return "flash-bwd" if flash else "B2r" if causal else "B2"
    if sym in ("dq_reduce_kernel", "dbias_reduce_kernel"):
        # B2r's own dq reduction lives in its source's anonymous namespace
        return SHARED_REDUCTION if "dense_bwd_mma::" in name else "B2r"
    if sym in PORT_SYMBOLS:
        return PORT_SYMBOLS[sym]
    low = name.lower()
    for kind, keys in (("gemm", _GEMM), ("copy/set", _COPY), ("reduction", _REDUCTION),
                       ("elementwise", _ELEMENTWISE)):
        if any(k in low for k in keys):
            return kind
    return "other"


def _complete(trace) -> List[dict]:
    return [e for e in trace["traceEvents"] if e.get("ph") == "X" and "ts" in e]


def load_ops(trace) -> List[dict]:
    """The device events (``kernel``, ``gpu_memcpy``, ``gpu_memset``) in
    start order: name, cat, kind, ts, end and dur (µs), stream, and the
    correlated launch's ts, thread and name (None where the trace has no
    launch with the event's correlation id)."""
    if isinstance(trace, str):
        trace = load_trace(trace)
    events = _complete(trace)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = []
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"]):
        launch = launches.get(e.get("args", {}).get("correlation"))
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        ops.append(dict(name=e["name"], cat=e["cat"], kind=classify(e["name"], e["cat"]), ts=ts,
                        dur=dur, end=ts + dur, stream=(e.get("pid"), e.get("tid")),
                        launch_ts=None if launch is None else float(launch["ts"]),
                        launch_tid=None if launch is None else launch.get("tid"),
                        launch_name=None if launch is None else launch["name"]))
    last = {}
    for op in ops:
        if op["kind"] == SHARED_REDUCTION:
            op["kind"] = last.get(op["stream"], SHARED_REDUCTION)
        elif op["kind"] in PORT_IDS:
            last[op["stream"]] = op["kind"]
    return ops


class _HostIndex:
    """Host events of each thread with their enclosing events, to name the
    innermost host event active at a time."""

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

    def stack_at(self, tid, t: float) -> List[dict]:
        """The host events of thread ``tid`` active at ``t``, outermost
        first."""
        th = self.threads.get(tid)
        if th is None:
            return []
        i = bisect.bisect_right(th["starts"], t) - 1
        out = []
        while i >= 0:
            e = th["events"][i]
            if e["ts"] <= t < e["ts"] + e.get("dur", 0.0):
                out.append(e)
            i = th["parents"][i]
        return out[::-1]


def _window(ops: List[dict], host: _HostIndex, main_tid, lo: float, hi: float, top_n: int,
            n_gaps: int) -> dict:
    """Wall, busy (the union), idle, launches, time by kind, the top ops and
    the longest idle gaps of the device events ``ops`` in [lo, hi] (µs)."""
    wall = hi - lo
    busy, gaps, cur = 0.0, [], lo
    for op in sorted(ops, key=lambda o: o["ts"]):
        s, f = max(op["ts"], lo), min(op["end"], hi)
        if s > cur:
            gaps.append((s - cur, cur, op))
        if f > max(s, cur):
            busy += f - max(s, cur)
        cur = max(cur, f)
    if ops and hi > cur:
        gaps.append((hi - cur, cur, None))
    by_kind, by_name = {}, {}
    for op in ops:
        k = by_kind.setdefault(op["kind"], dict(ms=0.0, count=0))
        k["ms"] += op["dur"] / 1e3
        k["count"] += 1
        n = by_name.setdefault(op["name"], dict(name=op["name"], kind=op["kind"], ms=0.0, count=0))
        n["ms"] += op["dur"] / 1e3
        n["count"] += 1
    total = sum(k["ms"] for k in by_kind.values())
    for k in by_kind.values():
        k["share"] = k["ms"] / total if total > 0 else 0.0
    longest = []
    for dur, start, after in sorted(gaps, key=lambda g: -g[0])[:n_gaps if ops else 0]:
        tid = after["launch_tid"] if after is not None and after["launch_tid"] is not None else main_tid
        stack = host.stack_at(tid, start)
        longest.append(dict(at_ms=(start - lo) / 1e3, ms=dur / 1e3,
                            host=stack[-1]["name"] if stack else None,
                            host_cat=stack[-1].get("cat") if stack else None,
                            stack=[e["name"] for e in stack],
                            next_op=None if after is None else after["name"]))
    return dict(
        wall_ms=wall / 1e3, busy_ms=busy / 1e3,
        idle=(1.0 - busy / wall) if ops and wall > 0 else None,
        launches=sum(op["cat"] == "kernel" for op in ops),
        copies=sum(op["cat"] != "kernel" for op in ops),
        by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms"])),
        top_ops=sorted(by_name.values(), key=lambda n: -n["ms"])[:top_n],
        op_counts={n: v["count"] for n, v in by_name.items()},
        gaps=longest)


def _host_ops(host_events: List[dict], top_n: int) -> List[dict]:
    """cpu_op names by inclusive host ms."""
    agg = {}
    for e in host_events:
        if e.get("cat") == "cpu_op":
            a = agg.setdefault(e["name"], dict(name=e["name"], ms=0.0, count=0))
            a["ms"] += e.get("dur", 0.0) / 1e3
            a["count"] += 1
    return sorted(agg.values(), key=lambda a: -a["ms"])[:top_n]


def summarize(path: str, top_n: int = 25, ranges: Optional[str] = None, n_gaps: int = 5,
              verbose: bool = True) -> dict:
    """The trace's summary (see the module docstring), printed when
    ``verbose``. With ``ranges``, ``out["ranges"]`` holds one summary per
    host range whose name starts with it; a device event goes with the range
    its launch lies in (one without a correlated launch with the event before
    it), and a range's window runs from its start to the later of its end
    and its last device event's."""
    src = find_trace(path)
    trace = load_trace(src)
    events = _complete(trace)
    ops = load_ops(trace)
    host_events = [e for e in events if e.get("cat") in HOST_CATS]
    host = _HostIndex(host_events)
    tids = collections.Counter(op["launch_tid"] for op in ops if op["launch_tid"] is not None)
    main_tid = tids.most_common(1)[0][0] if tids else None
    timed = [e for e in events if e.get("cat") in HOST_CATS + DEVICE_CATS + LAUNCH_CATS]
    lo = min((float(e["ts"]) for e in timed), default=0.0)
    hi = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed), default=0.0)
    out = dict(trace=src, device=bool(ops), **_window(ops, host, main_tid, lo, hi, top_n, n_gaps))
    out["host_ops"] = _host_ops(host_events, top_n)
    if ranges is not None:
        spans = sorted((e for e in host_events if e.get("cat") == "user_annotation"
                        and str(e["name"]).startswith(ranges)), key=lambda e: e["ts"])
        starts = [float(e["ts"]) for e in spans]
        owned = collections.defaultdict(list)
        current = None
        for op in ops:
            t = op["launch_ts"]
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= starts[i] + spans[i].get("dur", 0.0):
                current = i
            elif t is not None:
                current = None
            if current is not None:
                owned[current].append(op)
        out["ranges"] = {}
        for i, e in enumerate(spans):
            r_ops = owned.get(i, [])
            r_hi = max([starts[i] + e.get("dur", 0.0)] + [op["end"] for op in r_ops])
            name = e["name"] if e["name"] not in out["ranges"] else f"{e['name']}#{i}"
            out["ranges"][name] = _window(r_ops, host, main_tid, starts[i], r_hi, top_n, n_gaps)
    if verbose:
        print("\n".join(format_summary(out, top_n)))
    return out


def format_window(res: dict, top_n: int = 25, indent: str = "") -> List[str]:
    """The lines of one window's summary (the whole trace's or a range's)."""
    if res["idle"] is None:
        head = f"wall {res['wall_ms']:.3f} ms, no device events"
    else:
        head = (f"wall {res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms (union), idle "
                f"{100 * res['idle']:.1f}%, {res['launches']} kernel launches, {res['copies']} copies/sets")
    lines = [indent + head]
    if res["by_kind"]:
        lines.append(indent + "by kind (summed device ms):")
        lines += [f"{indent}  {v['ms']:10.3f} ms {100 * v['share']:5.1f}% x{v['count']:<6d} {k}"
                  for k, v in res["by_kind"].items()]
        lines.append(indent + "top ops:")
        lines += [f"{indent}  {v['ms']:10.3f} ms x{v['count']:<6d} [{v['kind']}] {v['name'][:100]}"
                  for v in res["top_ops"][:top_n]]
    if res["gaps"]:
        lines.append(indent + "longest idle gaps (the host event active on the launching thread):")
        lines += [f"{indent}  {g['ms']:9.3f} ms at +{g['at_ms']:.3f} ms: "
                  f"{' > '.join(g['stack'][-4:]) or 'no host event'}; next {str(g['next_op'])[:60]}"
                  for g in res["gaps"]]
    return lines


def format_summary(res: dict, top_n: int = 25) -> List[str]:
    lines = [res["trace"]]
    if not res["device"]:
        lines.append("no device events in this trace (taken on the CPU, or the card was not traced); "
                     "host summary:")
    lines += format_window(res, top_n)
    if not res["device"]:
        lines.append("host ops (inclusive ms):")
        lines += [f"  {v['ms']:10.3f} ms x{v['count']:<6d} {v['name']}" for v in res["host_ops"]]
    for name, r in (res.get("ranges") or {}).items():
        lines.append(f"== {name}")
        lines += format_window(r, min(top_n, 10), "  ")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a trace.json, or a directory holding one")
    p.add_argument("top_n", nargs="?", type=int, default=25)
    p.add_argument("--ranges", default=None, help="summarize each host range named PREFIX...")
    args = p.parse_args(argv)
    summarize(args.path, args.top_n, ranges=args.ranges)
    return 0


if __name__ == "__main__":
    sys.exit(main())
