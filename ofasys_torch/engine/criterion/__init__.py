from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.engine.criterion.cross_entropy import (
    CrossEntropyCriterion,
    CrossEntropyCriterionConfig,
    SpeechToTextCriterion,
    SpeechToTextCriterionConfig,
)
from ofasys_torch.engine.criterion.diffusion_loss import DiffusionCriterion, DiffusionCriterionConfig
from ofasys_torch.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)

__all__ = [
    "BaseCriterion", "CriterionConfig",
    "LabelSmoothedCrossEntropyCriterion", "LabelSmoothedCrossEntropyCriterionConfig",
    "CrossEntropyCriterion", "CrossEntropyCriterionConfig",
    "SpeechToTextCriterion", "SpeechToTextCriterionConfig",
    "DiffusionCriterion", "DiffusionCriterionConfig",
]
