"""TraverseTask: closed-set scoring (counterpart of ofasys_tpu/task/traverse_task.py).

Instead of free generation, every candidate answer is scored by the model
and the argmax picked: the evaluation mode of the classification and VQA
tasks. Each candidate is teacher-forced through one encoder pass and one
full decoder pass over the batch, and its token log-probabilities summed
over the non-pad targets (per candidate, as ofasys_tpu scores them; one
encoder pass per batch is ROADMAP Queue A item 6's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.ops.losses import token_log_probs
from ofasys_torch.task.base import Task, TaskConfig
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device


@dataclasses.dataclass
class TraverseTaskConfig(TaskConfig):
    pass


@register_config("ofasys.task", "traverse", TraverseTaskConfig)
class TraverseTask(Task):
    """The candidate answers are the text preprocessor's ``ans2label``
    table; ``rank_answers`` scores them all."""

    def candidate_answers(self) -> List[str]:
        pre = self.general_preprocess.name2pre["text"]
        if pre.ans2label:
            return list(pre.ans2label.keys())
        raise ValueError(f"task {self.name}: no candidate answer set configured")

    def answer_scores(self, model, sample: Dict[str, Any], answers: List[str]) -> np.ndarray:
        """(B, len(answers)) float64: sum over the non-pad target tokens of
        log p(answer token | input), one encoder and decoder pass of the
        model's own parameters per candidate."""
        pre = self.general_preprocess.name2pre["text"]
        d = self.global_dict
        net = model.net
        slots = sample["net_input"]["slots"]
        src = [s for s in slots if s.is_src]
        tgt_slot = SlotBatch.target_slot(slots)
        B = next(iter(src[0].value.values())).shape[0]
        src = slots_to_device(src, net.device)
        scores = np.zeros((B, len(answers)), np.float64)
        with torch.no_grad():
            for ai, a in enumerate(answers):
                toks = torch.from_numpy(np.concatenate([[d.bos()], pre.encode(a), [d.eos()]]).astype(np.int64))
                prev = toks[:-1][None].expand(B, -1).to(net.device)
                target = toks[1:][None].expand(B, -1).to(net.device)
                tgt = dataclasses.replace(tgt_slot, value={"inputs": prev})
                out, _ = net.decode_full([tgt], net.encode(src))
                tok_lp = token_log_probs(out, target)
                s = torch.where(target != d.pad(), tok_lp, torch.zeros_like(tok_lp)).sum(-1)
                scores[:, ai] = s.cpu().numpy()
        return scores

    def rank_answers(self, model, params, sample: Dict[str, Any],
                     answers: Optional[List[str]] = None) -> List[str]:
        """For each sample pick argmax_a sum log p(a | input). ``params``: a
        flax parameter tree to load into the model first, or None."""
        if params is not None:
            from ofasys_torch.utils.jax_params import load_jax_params

            load_jax_params(model.net, params)
        answers = answers or self.candidate_answers()
        best = self.answer_scores(model, sample, answers).argmax(axis=1)
        return [answers[i] for i in best]

    def evaluate(self, model, params, split: str = "valid", max_batches: Optional[int] = None,
                 rank: int = 0, world_size: int = 1) -> Dict[str, float]:
        """Closed-set evaluation: every candidate answer is scored and the
        argmax compared with the reference."""
        if params is not None:
            from ofasys_torch.utils.jax_params import load_jax_params

            load_jax_params(model.net, params)
        it = self.get_batch_iterator(split, rank=rank, world_size=world_size)
        answers = self.candidate_answers()
        text_pre = self.general_preprocess.name2pre["text"]
        hyps: List[str] = []
        refs: List[str] = []
        for i, batch in enumerate(it.next_epoch_itr(shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            picks = self.rank_answers(model, None, batch, answers)
            n_valid = batch.get("n_valid", len(picks))
            hyps.extend(picks[:n_valid])
            for b in range(n_valid):
                refs.append(text_pre.decode(np.asarray(batch["target"])[b]))
        results: Dict[str, float] = {}
        for metric in self.metrics:
            results.update(metric.compute(hyps, refs))
        return results
