"""Plain cross entropy and the ASR criterion (counterpart of
ofasys_tpu/engine/criterion/cross_entropy.py).

``CrossEntropyCriterion`` is label-smoothed CE at smoothing 0.
``SpeechToTextCriterion`` (``speech_to_text_loss``, the asr task's
criterion) is label-smoothed CE over the transcript tokens, plus, in
ofasys_tpu, ``ctc_weight`` times a CTC loss of the encoder states against
the phone targets that the PHONE preprocessor puts in
``sample["encoder_target"]``. That preprocessor is not ported (ROADMAP
Queue A item 11): where the CTC branch would run, this criterion raises;
everywhere else it computes what ofasys_tpu computes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)


@dataclass
class CrossEntropyCriterionConfig(LabelSmoothedCrossEntropyCriterionConfig):
    label_smoothing: float = 0.0


@register_config("ofasys.criterion", "cross_entropy", CrossEntropyCriterionConfig)
class CrossEntropyCriterion(LabelSmoothedCrossEntropyCriterion):
    """label_smoothing = 0 specialization."""


@dataclass
class SpeechToTextCriterionConfig(LabelSmoothedCrossEntropyCriterionConfig):
    label_smoothing: float = 0.1
    ce_weight: float = 1.0
    ctc_weight: float = 0.0


@register_config("ofasys.criterion", "speech_to_text_loss", SpeechToTextCriterionConfig)
class SpeechToTextCriterion(LabelSmoothedCrossEntropyCriterion):
    """ASR: token CE over transcripts (``ce_weight * CE + ctc_weight * CTC``
    in ofasys_tpu, the CTC term only where the sample has phone targets)."""

    def __call__(self, model, sample, generator=None, train: bool = True):
        if self.cfg.ctc_weight > 0.0 and "encoder_target" in sample:
            raise NotImplementedError(
                "speech_to_text_loss with ctc_weight > 0 (the CTC loss on encoder states against "
                "the PHONE preprocessor's encoder_target) is not ported yet (ROADMAP Queue A item 11)"
            )
        return super().__call__(model, sample, generator, train=train)
