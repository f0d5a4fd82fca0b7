"""Tacotron2-style TTS loss (counterpart of
ofasys_tpu/engine/criterion/tacotron2_loss.py, ``ofa_tacotron2``).

L1 + MSE on the mel frames before and after the postnet, plus an EOS BCE
whose positive (the last valid frame) weighs ``bce_pos_weight``, all masked
by the target lengths and in fp32. With ``use_guided_attention_loss`` the
decoder's cross-attention probabilities are read through
:class:`~ofasys_torch.model.transformer.AttentionProbs` and penalized for
straying off the diagonal (Tachibana et al.), averaged over every decoder
cross-attention map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.model.transformer import AttentionProbs


@dataclass
class Tacotron2CriterionConfig(CriterionConfig):
    use_guided_attention_loss: bool = False
    guided_attention_loss_sigma: float = 0.4
    bce_pos_weight: float = 5.0


def _cross_attention(name: str) -> bool:
    return name.split(".")[-1] == "encoder_attn"


@register_config("ofasys.criterion", "ofa_tacotron2", Tacotron2CriterionConfig)
class Tacotron2Criterion(BaseCriterion):
    def __call__(self, model, sample, generator=None, train: bool = True):
        slots = sample["net_input"]["slots"]
        ga_loss = None
        if self.cfg.use_guided_attention_loss:
            with AttentionProbs(model.net, _cross_attention) as obs:
                mel_post, extra = model.apply_train(slots, deterministic=not train, generator=generator)
        else:
            mel_post, extra = model.apply_train(slots, deterministic=not train, generator=generator)
        target = sample["target"].float()                            # (B, T, M)
        lengths = torch.as_tensor(sample["target_lengths"], device=target.device)
        if self.cfg.use_guided_attention_loss:
            ga_loss = self._guided_attention([p for _, p in obs.maps], lengths)
        B, T = target.shape[:2]
        zero = torch.zeros((), device=target.device)
        mask = torch.arange(T, device=target.device)[None, :] < lengths[:, None]   # (B, T)
        fmask = mask[:, :, None]

        mel_before = extra["feature_before"]
        l1 = (mel_post - target).abs() + (mel_before - target).abs()
        mse = (mel_post - target) ** 2 + (mel_before - target) ** 2
        l1 = torch.where(fmask, l1, zero).sum()
        mse = torch.where(fmask, mse, zero).sum()

        # EOS supervision: 1 at the last valid frame, 0 elsewhere
        eos_logits = extra["eos_logits"]
        eos_target = (torch.arange(T, device=target.device)[None, :] == (lengths[:, None] - 1)).float()
        bce = F.binary_cross_entropy_with_logits(eos_logits, eos_target, reduction="none")
        w = torch.where(eos_target > 0, torch.full((), self.cfg.bce_pos_weight, device=zero.device),
                        torch.ones((), device=zero.device))
        bce = torch.where(mask, bce * w, zero).sum()

        ntokens = lengths.sum()
        nf = ntokens.float()
        denom = torch.clamp(nf * target.shape[-1], min=1.0)
        n1 = torch.clamp(ntokens, min=1).float()
        loss = (l1 + mse) / denom * nf + bce / n1
        logging = {
            "loss": loss.detach(),
            "l1_loss": (l1 / denom).detach(),
            "mse_loss": (mse / denom).detach(),
            "eos_loss": (bce / n1).detach(),
            "ntokens": ntokens,
            "nsentences": B,
            "sample_size": nf,
        }
        if ga_loss is not None:
            loss = loss + ga_loss * nf
            logging["guided_attention_loss"] = ga_loss.detach()
            logging["loss"] = loss.detach()
        return loss, nf, logging

    def _guided_attention(self, maps: List[torch.Tensor], lengths: torch.Tensor) -> torch.Tensor:
        """The mean over ``maps`` ((B, H, Tq, Tk) each) of the head-mean
        attention mass weighted by 1 - exp(-(s/S - t/T_b)^2 / (2 sigma^2)),
        over each sample's valid target rows."""
        if not maps:
            return torch.zeros((), device=lengths.device)
        sigma = self.cfg.guided_attention_loss_sigma
        total = torch.zeros((), device=lengths.device)
        for attn in maps:
            B, H, Tq, Tk = attn.shape
            dev = attn.device
            t = torch.arange(Tq, device=dev)[:, None] / torch.clamp(lengths[:, None, None], min=1)
            s = torch.arange(Tk, device=dev)[None, :] / Tk
            w = 1.0 - torch.exp(-((s[None] - t) ** 2) / (2.0 * sigma * sigma))    # (B, Tq, Tk)
            tmask = (torch.arange(Tq, device=dev)[None, :] < lengths[:, None])[:, :, None]
            penalty = torch.where(tmask, attn.mean(dim=1) * w, torch.zeros((), device=dev))
            denom = torch.clamp(tmask.sum() * Tk, min=1)
            total = total + penalty.sum() / denom.float()
        return total / len(maps)
