"""Self-critical sequence training (counterpart of
ofasys_tpu/engine/criterion/scst_loss.py, ``scst_reward_criterion``).

Sample ``scst_n_samples`` hypotheses per source with the sampling
``SequenceGenerator``, score each with CIDEr-D against its references,
subtract the mean reward over the samples as the baseline, and scale each
sequence's log-probability by its advantage. Sampling and CIDEr run on the
host; the policy gradient is one teacher-forced scoring pass through
autograd over all sampled sequences. ``scst_train_step`` is one update on
the port's ``TrainState`` and optimizers: the trainer's ``fit`` does not
drive this criterion (its ``__call__`` raises, as ofasys_tpu's does).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.metric.base import MetricConfig
from ofasys_torch.metric.metrics import CiderMetric
from ofasys_torch.ops.losses import token_log_probs
from ofasys_torch.preprocessor.utils import collate_tokens
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device


@dataclass
class ScstRewardCriterionConfig(CriterionConfig):
    scst_n_samples: int = 5
    sampling_topk: int = 50
    ignore_prefix_size: int = 0


def _repeat_rows(value: Any, n: int) -> Any:
    """Each row of every array of a slot value repeated ``n`` times in a
    row (B-major), as ``jnp.repeat(x, n, axis=0)``."""
    if isinstance(value, dict):
        return {k: _repeat_rows(v, n) for k, v in value.items()}
    if isinstance(value, torch.Tensor) and value.dim() > 0:
        return value.repeat_interleave(n, dim=0)
    return value


@register_config("ofasys.criterion", "scst_reward_criterion", ScstRewardCriterionConfig)
class ScstRewardCriterion(BaseCriterion):
    """Needs a sampling generator and the text preprocessor:
    ``setup(generator, text_preprocess)`` before training."""

    def __init__(self, cfg: ScstRewardCriterionConfig, pad_id: int = 1):
        super().__init__(cfg, pad_id)
        self.generator = None
        self.text_pre = None
        self.cider = CiderMetric(MetricConfig())

    def setup(self, generator, text_preprocess):
        self.generator = generator
        self.text_pre = text_preprocess
        return self

    # ---- host side: sample + reward
    def sample_and_reward(self, sample: Dict[str, Any], refs: List[List[str]],
                          seed: int = 0) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
        """(the n * B sampled token arrays, sample-major; rewards (n, B);
        advantages (n, B), the rewards less their mean over the samples)."""
        n = self.cfg.scst_n_samples
        all_tokens: List[np.ndarray] = []
        rewards: List[float] = []
        for s in range(n):
            outs = self.generator.generate(sample, seed=seed * 1000 + s)
            for b, hyps in enumerate(outs):
                toks = np.asarray(hyps[0].tokens, np.int32)
                all_tokens.append(toks)
                text = self.text_pre.decode(toks)
                rewards.append(self.cider.compute([text], [refs[b]])["cider"])
        R = np.asarray(rewards, np.float32).reshape(n, len(refs))
        return all_tokens, R, R - R.mean(axis=0, keepdims=True)

    # ---- device side: policy gradient
    def policy_gradient_loss(self, model, sample: Dict[str, Any], sampled_tokens: List[np.ndarray],
                             advantage: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(-sum of advantage * sequence log-prob, the number of scored
        tokens): one deterministic teacher-forced pass with gradients. The
        samples go B-major, each source repeated n times; ``prev`` starts
        at id 0; both are padded to a multiple of 8."""
        n, B = advantage.shape
        net = model.net
        device = net.device
        prev = collate_tokens([np.concatenate([[0], t[:-1]]) for t in sampled_tokens],
                              pad_idx=self.pad_id, pad_to_multiple=8)
        target = collate_tokens(list(sampled_tokens), pad_idx=self.pad_id, pad_to_multiple=8)
        order = np.arange(n * B).reshape(n, B).T.reshape(-1)
        prev = torch.as_tensor(prev[order], dtype=torch.long, device=device)
        target = torch.as_tensor(target[order], dtype=torch.long, device=device)
        adv = torch.as_tensor(advantage.T.reshape(-1), dtype=torch.float32, device=device)

        slots = sample["net_input"]["slots"]
        src = [dataclasses.replace(s, value=_repeat_rows(s.value, n))
               for s in slots_to_device(SlotBatch.source_slots(slots), device)]
        tgt = dataclasses.replace(SlotBatch.target_slot(slots), value={"inputs": prev})
        out, _ = net.decode_full([tgt], net.encode(src))
        tok_lp = token_log_probs(out, target)
        valid = target != self.pad_id
        if self.cfg.ignore_prefix_size > 0:
            # the first positions are left out of the policy score
            pos = torch.arange(valid.shape[1], device=device)[None, :]
            valid = valid & (pos >= self.cfg.ignore_prefix_size)
        seq_lp = torch.where(valid, tok_lp, torch.zeros((), device=device)).sum(-1)
        return -(adv * seq_lp).sum(), valid.sum()

    def __call__(self, model, sample, generator=None, train: bool = True):
        raise NotImplementedError(
            "SCST samples on the host: drive it with engine/criterion/scst_loss.py:scst_train_step")


def scst_train_step(criterion: ScstRewardCriterion, model, state, optimizer, sample,
                    refs: List[List[str]], seed: int = 0):
    """One SCST update: host sampling and reward, then the policy gradient
    scaled by 1 / ntokens through ``optimizer`` on ``state`` (a
    ``TrainState`` over the net's parameters). Returns (state, {"loss",
    "reward"})."""
    tokens, rewards, advantage = criterion.sample_and_reward(sample, refs, seed)
    loss, ntokens = criterion.policy_gradient_loss(model, sample, tokens, advantage)
    grads = torch.autograd.grad(loss, state.params, allow_unused=True)
    scale = 1.0 / max(float(ntokens), 1.0)
    grads = [torch.zeros_like(p) if g is None else g * scale for g, p in zip(grads, state.params)]
    with torch.no_grad():
        state.opt_state = optimizer.step(state.params, grads, state.opt_state)
    state.step += 1
    return state, {"loss": float(loss.detach()) * scale, "reward": float(rewards.mean())}
