"""Masked-audio-model pretraining loss (counterpart of
ofasys_tpu/engine/criterion/speech_pretrain_loss.py,
``speech_pretrain_loss``).

Loss = mam_weight * KL(teacher || student) on the masked frames
     + dec_weight * label-smoothed CE on the decoder targets.

In a training call on an audio-only source, wav2vec-style span masks over
the subsampled frames (``span_mask``, drawn from the step's
``torch.Generator``; ofasys_tpu draws them from ``jax.random``) put the
audio adaptor's mask embedding in the student's encoder pass. The teacher
pass encodes the unmasked source under ``torch.no_grad``. Both project onto
the rows that ``get_start_end_idx("<phone>")`` gives, as in ofasys_tpu:
the ``<phone>`` rows where the dictionary has them; (-1, -1), no rows,
where it has none, and the KL term is then 0. The first
``mam_num_classes`` rows of ``<text>`` are taken only where that lookup
raises, and the first rows of the embedding where there is no dictionary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import ConfigStore, register_config
from ofasys_torch.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)


def subsampled_length(T: int, stride: int) -> int:
    """Frame count after the audio adaptor's strided convolutions (kernel
    5, stride 2, padding 2 a stage)."""
    n = max(1, int(stride).bit_length() - 1)
    for _ in range(n):
        T = (T + 2 * 2 - 5) // 2 + 1
    return T


def span_mask(generator: torch.Generator, B: int, T: int, mask_prob: float, mask_length: int,
              device=None) -> torch.Tensor:
    """(B, T) bool wav2vec-style span masks: max(1, round(mask_prob * T /
    mask_length)) spans of ``mask_length`` frames a row, starts uniform in
    [0, max(T - mask_length, 1)); spans may overlap, and frames past T are
    dropped."""
    n_spans = max(1, int(mask_prob * T / mask_length + 0.5))
    starts = torch.randint(0, max(T - mask_length, 1), (B, n_spans), generator=generator,
                           device=device)
    idx = (starts[:, :, None] + torch.arange(mask_length, device=device)[None, None, :]).reshape(B, -1)
    idx = torch.clamp(idx, max=T)                 # T: the dropped column
    mask = torch.zeros((B, T + 1), dtype=torch.bool, device=device)
    mask.scatter_(1, idx, True)
    return mask[:, :T]


@dataclass
class SpeechPretrainCriterionConfig(LabelSmoothedCrossEntropyCriterionConfig):
    mam_weight: float = 1.0
    dec_weight: float = 1.0
    mask_prob: float = 0.65
    mask_length: int = 10
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 10
    mam_num_classes: int = 1024


@register_config("ofasys.criterion", "speech_pretrain_loss", SpeechPretrainCriterionConfig)
class SpeechPretrainCriterion(LabelSmoothedCrossEntropyCriterion):
    global_dict = None  # attached by Task.initialize

    def _proj_range(self, vocab: int):
        d = self.global_dict
        if d is not None:
            try:
                return d.get_start_end_idx("<phone>")
            except Exception:
                pass
            try:
                start, end = d.get_start_end_idx("<text>")
                return start, min(end, start + self.cfg.mam_num_classes)
            except Exception:
                pass
        return 0, min(vocab, self.cfg.mam_num_classes)

    def __call__(self, model, sample, generator=None, train: bool = True,
                 frame_mask: Optional[torch.Tensor] = None,
                 channel_mask: Optional[torch.Tensor] = None):
        """``frame_mask`` (B, Ts) and ``channel_mask`` (B, M) replace the
        drawn masks (tests hand in the ones ofasys_tpu drew)."""
        cfg = self.cfg
        slots = sample["net_input"]["slots"]
        net = model.net
        src = [s for s in slots if s.is_src]
        tgt = [s for s in slots if not s.is_src]
        gen = generator if train else None

        audio_only = len(src) == 1 and src[0].modality == ModalityType.AUDIO
        do_mam = train and generator is not None and cfg.mam_weight > 0 and audio_only

        student_src = src
        if do_mam:
            s0 = src[0]
            B, T, M = s0.value["inputs"].shape
            device = s0.value["inputs"].device
            if frame_mask is None:
                stride = int(ConfigStore().get("ofasys.adaptor", "audio_fbank").config.subsample_stride)
                frame_mask = span_mask(generator, B, subsampled_length(T, stride), cfg.mask_prob,
                                       cfg.mask_length, device)
            v = dict(s0.value)
            v["mask_indices"] = frame_mask
            if cfg.mask_channel_prob > 0:
                if channel_mask is None:
                    channel_mask = span_mask(generator, B, M, cfg.mask_channel_prob,
                                             cfg.mask_channel_length, device)
                v["mask_channel_indices"] = channel_mask
            student_src = [dataclasses.replace(s0, value=v)]

        student_enc = net.encode(student_src, gen)
        logits, _ = net.decode_full(tgt, student_enc, all_slots=list(student_src) + list(tgt),
                                    generator=gen)
        ce_loss, sample_size, logging = self.compute_loss(logits, sample, train=train)
        loss = cfg.dec_weight * ce_loss

        if do_mam:
            with torch.no_grad():
                teacher_x = net.encode(src).x.float()
                emb = net.embed_tokens.full_weight()
                start, end = self._proj_range(emb.shape[0])
                emb = emb[start:end].float()
                t_lp = torch.log_softmax(teacher_x @ emb.t(), dim=-1)         # (B, Ts, R)
            s_lp = torch.log_softmax(student_enc.x.float() @ emb.t(), dim=-1)
            kl_pos = torch.sum(torch.exp(t_lp) * (t_lp - s_lp), dim=-1)      # (B, Ts)
            valid = frame_mask.bool() & torch.logical_not(student_enc.padding_mask)
            mam_loss = torch.where(valid, kl_pos, torch.zeros((), device=kl_pos.device)).sum()
            n_masked = torch.clamp(valid.sum(), min=1)
            # scaled like a per-token loss, so the two terms are comparable
            mam_loss = mam_loss / n_masked.float() * torch.clamp(
                torch.as_tensor(sample_size, dtype=torch.float32), min=1.0)
            loss = loss + cfg.mam_weight * mam_loss
            logging = dict(logging)
            logging["mam_loss"] = mam_loss.detach()
            logging["n_masked"] = n_masked
        logging["loss"] = loss.detach()
        return loss, sample_size, logging
