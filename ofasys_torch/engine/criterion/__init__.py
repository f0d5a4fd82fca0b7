from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)

__all__ = [
    "BaseCriterion", "CriterionConfig",
    "LabelSmoothedCrossEntropyCriterion", "LabelSmoothedCrossEntropyCriterionConfig",
]
