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

from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig


@dataclass
class LabelSmoothedCrossEntropyCriterionConfig(CriterionConfig):
    label_smoothing: float = 0.1
    report_accuracy: bool = False
    ignore_eos: bool = False
    drop_worst_ratio: float = 0.0
    drop_worst_after: int = 0
    # ofasys_tpu's chunked-vocab fused CE (ops/fused_ce.py)
    chunked_vocab: bool = False


class LabelSmoothedCrossEntropyCriterion(BaseCriterion):
    def __call__(self, model, sample, generator=None, train: bool = True):
        if self.cfg.chunked_vocab:
            raise NotImplementedError(
                "chunked_vocab (the fused chunked-vocab CE of ofasys_tpu/ops/fused_ce.py) "
                "is not ported yet (ROADMAP Queue A item 12)"
            )
        logits, _ = model.apply_train(sample["net_input"]["slots"], deterministic=not train,
                                      generator=generator)
        return self.compute_loss(logits, sample, train=train)

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
