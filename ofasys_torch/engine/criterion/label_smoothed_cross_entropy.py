"""Label-smoothed cross entropy (counterpart of
ofasys_tpu/engine/criterion/label_smoothed_cross_entropy.py).

The loss is computed in ofasys_tpu's logsumexp form, with fp32 sums over
the compute-dtype logits: ``nll = lse - z_t`` and ``sum_v log p_v =
sum_v z_v - V lse``. The target logit ``z_t`` is gathered from the logits
in their own dtype and then cast, as ofasys_tpu gathers from the bf16
logits. Where a position carries a closed-set constraint mask, the
smoothing mass spreads only over the allowed tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ofasys_torch import ModalityType
from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.ops.fused_ce import chunked_ce_stats, pick_chunks


@dataclass
class LabelSmoothedCrossEntropyCriterionConfig(CriterionConfig):
    label_smoothing: float = 0.1
    report_accuracy: bool = False
    ignore_eos: bool = False
    drop_worst_ratio: float = 0.0
    drop_worst_after: int = 0
    # the chunked-vocab fused CE (ops/fused_ce.py), where it applies
    chunked_vocab: bool = False


@register_config("ofasys.criterion", "label_smoothed_cross_entropy", LabelSmoothedCrossEntropyCriterionConfig)
class LabelSmoothedCrossEntropyCriterion(BaseCriterion):
    def __call__(self, model, sample, generator=None, train: bool = True):
        slots = sample["net_input"]["slots"]
        n_chunks = self._fused_plan(model, sample)
        out, extra = model.apply_train(slots, deterministic=not train, generator=generator,
                                       hidden_only=n_chunks is not None)
        if n_chunks is None:
            return self.compute_loss(out, sample, train=train)
        x = extra["decoder_hidden"]
        B, T, E = x.shape
        return self.compute_loss_fused(x.reshape(B * T, E), model.net.embed_tokens.weight,
                                       n_chunks, sample, train=train)

    # ------------------------------------------- chunked-vocab fused path
    def _fused_plan(self, model, sample):
        """The number of vocabulary chunks when the chunked-vocab CE applies,
        else None: ofasys_tpu's gates, decided before the forward (the
        decoder's hidden states of a TEXT target are (B, T, E) and the text
        adaptor's logits span the embedding's rows, so its checks on them
        hold)."""
        cfg = self.cfg
        if not cfg.chunked_vocab or cfg.report_accuracy:
            return None
        if sample.get("constraint_masks") is not None:
            return None
        try:
            tgt_slots = [s for s in sample["net_input"]["slots"] if not s.is_src]
        except (KeyError, TypeError):
            return None
        if len(tgt_slots) != 1 or tgt_slots[0].modality != ModalityType.TEXT:
            return None
        target = sample["target"]
        if (not isinstance(target, torch.Tensor) or target.dim() != 2
                or target.is_floating_point() or target.dtype == torch.bool):
            return None
        # an untied output projection or an output bias: the logits would
        # not be x @ emb^T
        for name, _ in model.net.named_parameters():
            if {"output_projection", "output_projection_bias"} & set(name.split(".")):
                return None
        return pick_chunks(model.net.embed_tokens.weight.shape[0])

    def compute_loss_fused(self, x2: torch.Tensor, emb: torch.Tensor, n_chunks: int, sample,
                           train: bool = True):
        """compute_loss's loss with (lse, z_t, rowsum) taken chunk by chunk
        over the vocabulary from the hidden states ``x2`` (N, E) and the
        tied table ``emb`` (V, E)."""
        cfg = self.cfg
        target = sample["target"]
        B, T = target.shape
        V = emb.shape[0]
        tgt = target.reshape(B * T).long()
        lse, z_t, zsum = chunked_ce_stats(x2, emb, tgt, n_chunks, x2.dtype)
        nll_pos = lse - z_t
        smooth = -(zsum - V * lse)
        valid = tgt != self.pad_id
        if cfg.ignore_eos:
            valid = valid & (tgt != getattr(self, "eos_id", 2))
        return self._reduce(nll_pos, smooth, float(V - 1), valid, tgt, sample, B, train)

    def compute_loss(self, logits: torch.Tensor, sample, train: bool = True):
        cfg = self.cfg
        target = sample["target"]                      # (B, T) int, pad = ignored
        B, T = target.shape
        V = logits.shape[-1]

        z = logits.reshape(B * T, V)
        zf = z.float()
        tgt = target.reshape(B * T).long()
        valid = tgt != self.pad_id
        if cfg.ignore_eos:
            valid = valid & (tgt != getattr(self, "eos_id", 2))
        zmax = zf.max(dim=-1, keepdim=True).values.detach()
        lse = zmax[:, 0] + torch.log(torch.exp(zf - zmax).sum(dim=-1))
        z_t = torch.gather(z, 1, tgt[:, None])[:, 0].float()
        nll_pos = lse - z_t

        cmask = sample.get("constraint_masks")
        if cmask is not None:
            cm = cmask.reshape(B * T, V)
            n_total = cm.sum(-1).float()
            smooth = -(torch.where(cm, zf, torch.zeros((), device=zf.device)).sum(-1) - n_total * lse)
            n_allowed = torch.clamp(n_total - 1.0, min=1.0)
        else:
            smooth = -(zf.sum(-1) - V * lse)
            n_allowed = float(V - 1)
        return self._reduce(nll_pos, smooth, n_allowed, valid, tgt, sample, B, train, z=z)

    def _reduce(self, nll_pos, smooth, n_allowed, valid, tgt, sample, B, train, z=None):
        cfg = self.cfg
        zero = torch.zeros((), device=nll_pos.device)
        eps_i = cfg.label_smoothing / n_allowed
        loss_pos = (1.0 - cfg.label_smoothing - eps_i) * nll_pos + eps_i * smooth
        loss_pos = torch.where(valid, loss_pos, zero)
        nll_pos = torch.where(valid, nll_pos, zero)

        # drop-worst: after drop_worst_after updates, keep only the
        # (1 - drop_worst_ratio) fraction of valid positions with the
        # smallest loss; rank-based, with no host sync
        if train and cfg.drop_worst_ratio > 0.0:
            update_num = sample.get("update_num")
            gate = (update_num > cfg.drop_worst_after if update_num is not None
                    else cfg.drop_worst_after <= 0)
            if gate:
                ranked = torch.where(valid, loss_pos.detach(), torch.full((), float("inf"),
                                                                          device=valid.device))
                order = torch.argsort(ranked, stable=True)
                rank = torch.empty_like(order)
                rank[order] = torch.arange(order.numel(), device=order.device)
                n_keep = torch.floor(valid.sum().float() * (1.0 - cfg.drop_worst_ratio)).long()
                keep = valid & (rank < n_keep)
                loss_pos = torch.where(keep, loss_pos, zero)
                nll_pos = torch.where(keep, nll_pos, zero)
                valid = keep

        ntokens = valid.sum()
        loss = loss_pos.sum()
        nll_loss = nll_pos.sum()
        sample_size = (torch.tensor(float(B), device=loss.device) if cfg.sentence_avg
                       else ntokens.float())
        logging_out = {
            "loss": loss.detach(),
            "nll_loss": nll_loss.detach(),
            "ntokens": ntokens,
            "nsentences": B,
            "sample_size": sample_size,
        }
        if cfg.report_accuracy and z is not None:
            pred = torch.argmax(z, dim=-1)
            logging_out["n_correct"] = (valid & (pred == tgt)).sum()
            logging_out["total"] = ntokens
        # the raw summed loss: the train step divides the accumulated
        # gradient by the total sample size once
        return loss, sample_size, logging_out
