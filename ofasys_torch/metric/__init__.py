from ofasys_torch.metric.base import BaseMetric, MetricConfig
from ofasys_torch.metric import metrics  # registers the metric zoo

__all__ = ["BaseMetric", "MetricConfig"]
