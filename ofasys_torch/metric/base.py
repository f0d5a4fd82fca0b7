"""Metric base (counterpart of ofasys_tpu/metric/base.py): ``compute(hyps,
refs)`` returns a logging dict; ``report`` aggregates logging dicts into
scalars."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

from ofasys_torch.configure.configs import BaseDataclass


@dataclass
class MetricConfig(BaseDataclass):
    is_active: bool = False
    target_field: str = "target"


class BaseMetric:
    def __init__(self, cfg: MetricConfig = None):
        self.cfg = cfg or MetricConfig()

    def compute(self, hyps: Sequence[Any], refs: Sequence[Any]) -> Dict[str, float]:
        raise NotImplementedError

    @classmethod
    def report(cls, logging_outputs: List[Dict[str, float]]) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        n = max(len(logging_outputs), 1)
        for log in logging_outputs:
            for k, v in log.items():
                agg[k] = agg.get(k, 0.0) + float(v) / n
        return agg


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
