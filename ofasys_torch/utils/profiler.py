"""Profiling and watchdog utilities (counterpart of
ofasys_tpu/utils/profiler.py), on ``torch.profiler`` and CUDA events:

  * profile(logdir)      — a torch.profiler trace of the block (the card's
                           activity too when CUDA is present), written to
                           ``logdir`` as a Chrome trace (``trace.json``;
                           view in Perfetto)
  * annotate(name)       — a ``record_function`` scope
  * time_fn              — mean seconds a call: CUDA events on the card, the
                           host clock on the CPU
  * Watchdog             — a heartbeat thread that dumps every stack and
                           optionally signals the process when no progress
                           is made within a timeout
  * device_memory_stats  — per-device memory from ``torch.cuda.memory_stats``
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional, Union

import torch

from ofasys_torch.utils.device import resolve_device

logger = logging.getLogger("ofasys_torch.profiler")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile(logdir: str = "ofasys_torch_profile"):
    """Trace the block; yields the profiler (its ``key_averages()`` and
    ``events()`` are read after the block). The trace goes to
    ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch_profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, TRACE_FILE)
        prof.export_chrome_trace(path)
        logger.info("profile trace written to %s", path)


def annotate(name: str):
    return torch.profiler.record_function(name)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            device: Union[str, torch.device] = "cuda") -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls: timed by
    CUDA events on a CUDA ``device`` (raises when CUDA is absent), by the
    host clock on the CPU."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:i": {bytes_in_use_gb, bytes_limit_gb, peak_gb}} for every
    visible card; empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 2**30,
            "bytes_limit_gb": torch.cuda.get_device_properties(i).total_memory / 2**30,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) / 2**30,
        }
    return out


class Watchdog:
    """Kill-switch for hung steps: call beat() each update; if no beat within
    ``timeout`` seconds, dump all thread stacks and send ``sig`` to self."""

    def __init__(self, timeout: float, sig: int = signal.SIGINT, kill: bool = True):
        self.timeout = timeout
        self.sig = sig
        self.kill = kill
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def beat(self):
        self._last = time.monotonic()

    def start(self):
        if self.timeout <= 0:
            return self

        def run():
            while not self._stop.wait(min(self.timeout / 4, 10.0)):
                if time.monotonic() - self._last > self.timeout:
                    self.fired = True
                    logger.error("watchdog: no progress in %.0fs — dumping stacks", self.timeout)
                    faulthandler.dump_traceback()
                    if self.kill:
                        os.kill(os.getpid(), self.sig)
                    self._last = time.monotonic()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
