"""Smoothed meters (counterpart of ofasys_tpu/logging/meters.py): average,
sum, rate and stopwatch meters and the priority-ordered MetersDict, each
with a ``state_dict`` that checkpoints carry."""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, Optional


class AverageMeter:
    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.val, self.sum, self.count = None, 0.0, 0.0

    def update(self, val, n=1):
        if val is not None:
            self.val = val
            self.sum += val * n
            self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else (self.val or 0.0)

    @property
    def smoothed_value(self):
        v = self.avg
        return round(v, self.round) if self.round is not None else v

    def state_dict(self):
        return {"val": self.val, "sum": self.sum, "count": self.count, "round": self.round}

    def load_state_dict(self, s):
        self.val, self.sum, self.count, self.round = s["val"], s["sum"], s["count"], s.get("round")


class SumMeter(AverageMeter):
    @property
    def smoothed_value(self):
        return round(self.sum, self.round) if self.round is not None else self.sum


class TimeMeter:
    """Rate meter: items per second since reset."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0

    def update(self, n=1):
        self.n += n

    @property
    def avg(self):
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0

    @property
    def smoothed_value(self):
        v = self.avg
        return round(v, self.round) if self.round is not None else v

    def state_dict(self):
        return {"n": self.n, "round": self.round}

    def load_state_dict(self, s):
        self.reset()
        self.n = s.get("n", 0)


class StopwatchMeter:
    def __init__(self):
        self.sum = 0.0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, n=1):
        if self._start is not None:
            self.sum += time.perf_counter() - self._start
            self._start = None

    @property
    def smoothed_value(self):
        return self.sum


class MetersDict(OrderedDict):
    """Priority-ordered meters with derived values on read."""

    def add_meter(self, name: str, meter, priority: int = 0):
        self[name] = meter
        meter._priority = priority
        self.move_to_end(name)
        for k in sorted(self, key=lambda k: getattr(self[k], "_priority", 0)):
            self.move_to_end(k)

    def get_smoothed_values(self) -> Dict[str, Any]:
        return {k: m.smoothed_value for k, m in self.items() if not k.startswith("_")}

    def state_dict(self):
        return {k: (type(m).__name__, m.state_dict()) for k, m in self.items()
                if hasattr(m, "state_dict")}

    def load_state_dict(self, state):
        for k, (cls_name, s) in state.items():
            cls = {"AverageMeter": AverageMeter, "SumMeter": SumMeter, "TimeMeter": TimeMeter}.get(cls_name)
            if cls is not None:
                m = cls()
                m.load_state_dict(s)
                self[k] = m
