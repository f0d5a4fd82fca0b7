"""Nested metrics aggregation contexts (counterpart of
ofasys_tpu/logging/metrics.py).

``with metrics.aggregate("valid"):`` routes log_scalar/log_speed calls into
every active context's MetersDict; state_dict round-trips through
checkpoints so smoothed meters survive resume.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ofasys_torch.logging.meters import AverageMeter, MetersDict, StopwatchMeter, SumMeter, TimeMeter

_local = threading.local()


def _active() -> Dict[str, MetersDict]:
    if not hasattr(_local, "stack"):
        _local.stack = {"default": MetersDict()}
        _local.order = ["default"]
    return _local.stack


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Open an aggregation context; yields its MetersDict."""
    stack = _active()
    name = name or str(uuid.uuid4())
    created = name not in stack
    if created:
        stack[name] = MetersDict()
    _local.order.append(name)
    saved = None
    if new_root:
        saved = _local.order
        _local.order = [name]
    try:
        yield stack[name]
    finally:
        if new_root:
            _local.order = saved
        else:
            _local.order.pop()


def _each():
    stack = _active()
    for name in set(_local.order):
        yield stack[name]


def log_scalar(key: str, value: float, weight: float = 1.0, priority: int = 10, round: Optional[int] = None):
    for m in _each():
        if key not in m:
            m.add_meter(key, AverageMeter(round=round), priority)
        m[key].update(value, weight)


def log_scalar_sum(key: str, value: float, priority: int = 10, round: Optional[int] = None):
    for m in _each():
        if key not in m:
            m.add_meter(key, SumMeter(round=round), priority)
        m[key].update(value)


def log_speed(key: str, n: float, priority: int = 30, round: Optional[int] = None):
    for m in _each():
        if key not in m:
            m.add_meter(key, TimeMeter(round=round), priority)
        m[key].update(n)


def log_start_time(key: str, priority: int = 40):
    for m in _each():
        if key not in m:
            m.add_meter(key, StopwatchMeter(), priority)
        m[key].start()


def log_stop_time(key: str):
    for m in _each():
        if key in m:
            m[key].stop()


def get_smoothed_values(name: str = "default") -> Dict[str, Any]:
    return _active().get(name, MetersDict()).get_smoothed_values()


def reset_meters(name: str = "default"):
    md = _active().get(name)
    if md is not None:
        for meter in md.values():
            if hasattr(meter, "reset"):
                meter.reset()


def state_dict() -> Dict[str, Any]:
    return {name: md.state_dict() for name, md in _active().items()}


def load_state_dict(state: Dict[str, Any]):
    stack = _active()
    for name, md_state in state.items():
        md = stack.setdefault(name, MetersDict())
        md.load_state_dict(md_state)
