"""Beam search over the GeneralistModel (counterpart of
ofasys_tpu/generator/sequence_generator.py).

The loop is a Python ``while`` with the same ``cond`` and ``body`` as
ofasys_tpu's ``lax.while_loop``:

  * the encoder runs once; encoder-out is beam-expanded to B*K rows
  * the decoder KV cache is reordered with one gather per step
  * EOS is forced at the final step, so exactly K finished hypotheses
    always exist
  * vocab shaping (min-len, unk penalty, constraint range, n-gram blocking,
    prefix forcing) are logit transforms from generator/search.py, in
    ofasys_tpu's order

Greedy decode is beam_size=1. Ensembles, tries, lexical constraints,
diverse search and sampling wait for a later slice and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.generator import search
from ofasys_torch.generator.base import SequenceGeneratorOutput
from ofasys_torch.model.ofa import EncoderOut
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device

NEG_INF = search.NEG_INF

# options of ofasys_tpu's generator that this slice does not run, with their
# defaults: any other value raises
_UNPORTED = {
    "sampling": False,
    "sampling_topk": -1,
    "sampling_topp": -1.0,
    "constraint_trie": None,
    "search_strategy": "beam",
    "num_groups": 2,
    "diversity_strength": 0.5,
    "diversity_rate": 0.5,
    "constraint_representation": "unordered",
}


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest along the last axis, ties
    broken toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) rows picked per batch by idx (B, K) -> (B, K, ...)."""
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def _gather_beams(cache: Dict[str, Any], beam_idx: torch.Tensor, batch: int, beam_size: int):
    """Reorder the self-attention KV cache of every layer by per-batch beam
    indices (B, K). Cross-attention K/V are the same for every beam of a
    sample and stay as they are."""
    rows = (torch.arange(batch, device=beam_idx.device)[:, None] * beam_size + beam_idx).reshape(-1)
    out = {}
    for name, layer in cache.items():
        sc = layer["self"]
        out[name] = {**layer, "self": {"k": sc["k"].index_select(0, rows),
                                       "v": sc["v"].index_select(0, rows),
                                       "index": sc["index"]}}
    return out


class SequenceGenerator:
    def __init__(
        self,
        model,                       # GeneralistModel
        dictionary,
        beam_size: int = 5,
        max_len_a: float = 0.0,
        max_len_b: int = 200,
        min_len: int = 1,
        temperature: float = 1.0,
        lenpen: float = 1.0,
        unkpen: float = 0.0,
        max_len: int = -1,
        normalize_scores: bool = True,
        match_source_len: bool = False,
        no_repeat_ngram_size: int = 0,
        constraint_range: Optional[str] = None,
        return_n_best: int = 1,
        **unported,
    ):
        if isinstance(model, (list, tuple)):
            raise NotImplementedError("ensemble decoding is not ported to ofasys_torch yet")
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SequenceGenerator got an unexpected option {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"generation option {name}={value!r} is not ported to ofasys_torch yet"
                )
        self.model = model
        self.dictionary = dictionary
        self.bos = dictionary.bos()
        self.eos = dictionary.eos()
        self.pad = dictionary.pad()
        self.unk = dictionary.unk()
        self.beam_size = beam_size
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.temperature = temperature
        self.lenpen = lenpen
        self.unkpen = unkpen
        self.max_len_cap = max_len
        self.normalize_scores = normalize_scores
        self.match_source_len = match_source_len
        self.ngram = no_repeat_ngram_size
        self.return_n_best = max(1, return_n_best)
        self.constraint_start = self.constraint_end = None
        if constraint_range:
            # both "lo,hi" and "(lo,hi)"
            lo, hi = constraint_range.strip("() ").split(",")
            self.constraint_start, self.constraint_end = int(lo), int(hi)

    # ----------------------------------------------------------- public API
    @torch.no_grad()
    def generate(self, sample: Dict[str, Any],
                 prefix_tokens: Optional[np.ndarray] = None) -> List[List[SequenceGeneratorOutput]]:
        device = self.model.net.device
        slots = sample["net_input"]["slots"]
        src_slots = slots_to_device([s for s in slots if s.is_src], device)
        tgt_slot = SlotBatch.target_slot(slots)
        # max_len = a * src_len + b
        src_len = 0
        for s in src_slots:
            x = s.value.get("inputs")
            if x is not None and x.dim() == 2:
                src_len = max(src_len, int(x.shape[1]))
        max_len = int(self.max_len_a * src_len + self.max_len_b)
        if self.max_len_cap > 0:
            max_len = min(max_len, self.max_len_cap)
        min_len = self.min_len
        if self.match_source_len and src_len > 0:
            max_len = min_len = src_len

        if prefix_tokens is None and sample.get("prefix_tokens") is not None:
            pt = np.asarray(sample["prefix_tokens"])
            if pt.size and pt.shape[1] > 0:
                prefix_tokens = pt
        prefix = None
        if prefix_tokens is not None:
            prefix = torch.as_tensor(np.asarray(prefix_tokens, np.int64), device=device)

        seqs, scores = self._generate(src_slots, tgt_slot, prefix, max_len=max_len, min_len=min_len)
        return self._finalize(seqs.cpu().numpy().astype(np.int32), scores.cpu().numpy())

    def _finalize(self, seqs: np.ndarray, scores: np.ndarray) -> List[List[SequenceGeneratorOutput]]:
        out: List[List[SequenceGeneratorOutput]] = []
        for b in range(seqs.shape[0]):
            order = np.argsort(-scores[b])[: self.return_n_best]
            hyps = []
            for k in order:
                toks = seqs[b, k, 1:]  # drop bos
                eos_pos = np.nonzero(toks == self.eos)[0]
                if eos_pos.size:
                    toks = toks[: eos_pos[0] + 1]
                hyps.append(SequenceGeneratorOutput(tokens=toks, score=float(scores[b, k])))
            out.append(hyps)
        return out

    def _norm(self, length: int) -> float:
        """Score normalizer: length**lenpen when normalize_scores, else 1."""
        if not self.normalize_scores:
            return 1.0
        return search.length_penalty(length, self.lenpen)

    # ------------------------------------------------------------ the loop
    def _generate(self, src_slots, tgt_slot, prefix_tokens, *, max_len: int, min_len: int):
        K = self.beam_size
        net = self.model.net
        enc = net.encode(src_slots)
        B = enc.x.shape[0]
        N = B * K
        T_buf = max_len + 2
        device = enc.x.device
        dummy = dataclasses.replace(
            tgt_slot, value={"inputs": torch.zeros((N, T_buf), dtype=torch.long, device=device)}
        )
        enc = EncoderOut(
            x=enc.x.repeat_interleave(K, dim=0),
            padding_mask=enc.padding_mask.repeat_interleave(K, dim=0),
            pos_embed=enc.pos_embed,  # batch-1, broadcastable
        )
        bias_spec, cross_bias, cache = net.decode_prepare([dummy], enc, T_buf)
        P = 0 if prefix_tokens is None else prefix_tokens.shape[1]

        seq = torch.full((B, K, T_buf), self.pad, dtype=torch.long, device=device)
        seq[:, :, 0] = self.bos
        alive_lp = torch.tensor([[0.0] + [NEG_INF] * (K - 1)], dtype=torch.float32,
                                device=device).repeat(B, 1)   # only beam 0 alive at start
        fin_seq = torch.zeros_like(seq)
        fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
        fin_flags = torch.zeros((B, K), dtype=torch.bool, device=device)
        rows = torch.arange(N, device=device)

        def cond(step):
            best_alive = alive_lp.max(dim=1).values / self._norm(max_len)
            worst_fin = torch.where(fin_flags, fin_scores, NEG_INF).min(dim=1).values
            improvable = torch.any(~fin_flags.all(dim=1) | (best_alive > worst_fin))
            return step <= max_len and bool(improvable)

        step = 0
        while cond(step):
            tokens = seq.reshape(N, T_buf)[:, step:step + 1]
            logits, _, cache = net.decode_step(tokens, step, enc, bias_spec, cross_bias, cache, tgt_slot)
            lp = logits[:, -1].float()
            if self.temperature != 1.0:
                lp = lp / self.temperature
            lp = torch.log_softmax(lp, dim=-1)
            V = lp.shape[-1]

            lp = search.apply_min_len(lp, step, min_len, self.eos)
            if self.unkpen:
                lp[:, self.unk] -= self.unkpen
            if self.constraint_start is not None:
                lp = search.apply_constraint_range(lp, self.constraint_start, self.constraint_end,
                                                   self.eos)
            if self.ngram > 0:
                lp = search.block_repeat_ngrams(lp, seq.reshape(N, T_buf), step + 1, self.ngram)
            if step == max_len:
                # force EOS at the last step so every beam finishes
                lp = torch.full_like(lp, NEG_INF)
                lp[:, self.eos] = 0.0
            if step < P:
                # force the prefix tokens during the first P steps
                tok = prefix_tokens[:, step].repeat_interleave(K)
                lp = torch.full_like(lp, NEG_INF)
                lp[rows, tok] = 0.0

            lp = lp.reshape(B, K, V)
            cand_lp = alive_lp[:, :, None] + lp                   # (B, K, V)
            flat = cand_lp.reshape(B, K * V)
            # the 2K best of K*V candidates: ties here sit at NEG_INF, below
            # at least 2K real candidates, so the fast unstable top-k is exact
            topk_lp, topk_idx = torch.topk(flat, 2 * K, dim=1)
            cand_beam = topk_idx // V
            cand_tok = topk_idx % V

            # extend sequences
            cand_seq = _take(seq, cand_beam)                       # (B, 2K, T)
            cand_seq[:, :, step + 1] = cand_tok
            is_eos = cand_tok == self.eos

            # ---- merge newly finished into the finished pool
            cand_scores = topk_lp / self._norm(step + 1)
            new_fin_scores = torch.where(is_eos, cand_scores, NEG_INF)
            all_fin_seq = torch.cat([fin_seq, cand_seq], dim=1)
            all_fin_scores = torch.cat([fin_scores, new_fin_scores], dim=1)
            all_fin_flags = torch.cat([fin_flags, is_eos], dim=1)
            fin_scores, top_fin_idx = _top_k(all_fin_scores, K)
            fin_seq = _take(all_fin_seq, top_fin_idx)
            fin_flags = _take(all_fin_flags, top_fin_idx)

            # ---- pick K alive (non-eos) candidates
            alive_cand_lp = torch.where(is_eos, NEG_INF, topk_lp)
            alive_lp, alive_idx = _top_k(alive_cand_lp, K)
            seq = _take(cand_seq, alive_idx)
            chosen_beam = _take(cand_beam, alive_idx)
            if K > 1:
                cache = _gather_beams(cache, chosen_beam, B, K)
            step += 1
        return fin_seq, fin_scores
