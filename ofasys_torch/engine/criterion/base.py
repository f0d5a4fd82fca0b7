"""Criterion base (counterpart of ofasys_tpu/engine/criterion/base.py).

A criterion is a callable ``(model, sample, generator, train) -> (loss,
sample_size, logging_out)``: the raw summed loss (a tensor that carries
gradients), the sample size the train step divides the summed gradients
by, and a dict of scalars. ``reduce_metrics`` aggregates the logging
outputs of microbatches and tasks on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List


@dataclass
class CriterionConfig:
    is_active: bool = False
    sentence_avg: bool = False


class BaseCriterion:
    def __init__(self, cfg: CriterionConfig, pad_id: int = 1):
        self.cfg = cfg
        self.pad_id = pad_id

    def __call__(self, model, sample, generator=None, train: bool = True):
        raise NotImplementedError

    @classmethod
    def reduce_metrics(cls, logging_outputs: List[Dict[str, Any]], task_name=None) -> Dict[str, float]:
        """Sum the summable fields and derive the means: loss per sample
        size, nll_loss per token, accuracy."""
        agg: Dict[str, float] = {}
        for log in logging_outputs:
            for k, v in log.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        out: Dict[str, float] = dict(agg)
        ntokens = agg.get("ntokens", 0) or 1
        sample_size = agg.get("sample_size", 0) or 1
        if "loss" in agg:
            out["loss"] = agg["loss"] / sample_size
        if "nll_loss" in agg:
            out["nll_loss"] = agg["nll_loss"] / ntokens
        if "n_correct" in agg and agg.get("total", 0) > 0:
            out["accuracy"] = agg["n_correct"] / agg["total"]
        return out
