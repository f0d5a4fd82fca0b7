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
from ofasys_torch.engine.criterion.scst_loss import (
    ScstRewardCriterion,
    ScstRewardCriterionConfig,
    scst_train_step,
)
from ofasys_torch.engine.criterion.speech_pretrain_loss import (
    SpeechPretrainCriterion,
    SpeechPretrainCriterionConfig,
)
from ofasys_torch.engine.criterion.tacotron2_loss import Tacotron2Criterion, Tacotron2CriterionConfig

__all__ = [
    "BaseCriterion", "CriterionConfig",
    "LabelSmoothedCrossEntropyCriterion", "LabelSmoothedCrossEntropyCriterionConfig",
    "CrossEntropyCriterion", "CrossEntropyCriterionConfig",
    "SpeechToTextCriterion", "SpeechToTextCriterionConfig",
    "DiffusionCriterion", "DiffusionCriterionConfig",
    "Tacotron2Criterion", "Tacotron2CriterionConfig",
    "SpeechPretrainCriterion", "SpeechPretrainCriterionConfig",
    "ScstRewardCriterion", "ScstRewardCriterionConfig", "scst_train_step",
]
