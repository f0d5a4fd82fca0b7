"""Plain cross entropy and the ASR criterion (counterpart of
ofasys_tpu/engine/criterion/cross_entropy.py).

``CrossEntropyCriterion`` is label-smoothed CE at smoothing 0.
``SpeechToTextCriterion`` (``speech_to_text_loss``, the asr task's
criterion) is label-smoothed CE over the transcript tokens, plus
``ctc_weight`` times a CTC loss of the encoder states against the phone
targets that the ``text_phone`` preprocessor puts in
``sample["encoder_target"]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.ops.losses import ctc_loss


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
    """ASR: ``ce_weight * CE + ctc_weight * CTC``, the CTC term only where
    the sample has phone targets.

    The CTC logits are the encoder states, in fp32, against the shared
    token embedding's ``<phone>`` rows; class 0 (the namespace's first row)
    is the blank. The labels are ``sample["encoder_target"]`` with pad and
    eos dropped, the loss ``ops.losses.ctc_loss`` (optax's, summed over the
    batch). ``ce_loss`` and ``ctc_loss`` are logged apart."""

    global_dict = None  # attached by Task.initialize

    def __call__(self, model, sample, generator=None, train: bool = True):
        cfg = self.cfg
        if cfg.ctc_weight <= 0.0 or "encoder_target" not in sample:
            return super().__call__(model, sample, generator, train=train)
        logits, extra = model.apply_train(sample["net_input"]["slots"], deterministic=not train,
                                          generator=generator)
        loss_ce, sample_size, logging = self.compute_loss(logits, sample, train=train)

        enc = extra["encoder_out"]
        start, end = self.global_dict.get_start_end_idx("<phone>")
        rows = model.net.embed_tokens.full_weight()[start:end].float()   # (K, E)
        ctc_logits = torch.einsum("bte,ke->btk", enc.x.float(), rows)     # (B, Ts, K)
        tgt = torch.as_tensor(sample["encoder_target"], device=ctc_logits.device)
        valid = (tgt != self.pad_id) & (tgt != self.global_dict.eos())
        labels = torch.where(valid, tgt - start, torch.zeros_like(tgt))
        loss_ctc = ctc_loss(ctc_logits, enc.padding_mask.float(), labels,
                            1.0 - valid.float(), blank_id=0).sum()

        loss = cfg.ce_weight * loss_ce + cfg.ctc_weight * loss_ctc
        logging = dict(logging)
        logging["ce_loss"] = loss_ce.detach()
        logging["ctc_loss"] = loss_ctc.detach()
        return loss, sample_size, logging
