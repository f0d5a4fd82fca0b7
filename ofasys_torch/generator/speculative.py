"""Speculative (draft-verify) greedy decoding (counterpart of
ofasys_tpu/generator/speculative.py).

A small DRAFT model proposes ``gamma`` tokens one by one; the TARGET model
scores all of them in ONE multi-token decode step (the decoder's
incremental path writes the step's rows at the cache index and masks
causally inside the step); the longest prefix on which the target's greedy
choice agrees is accepted, plus one target "correction" token. Each
iteration grows the sequence by 1..gamma+1 tokens for one target step.

EXACTNESS: the output is the target's own greedy decode, whatever the
draft: the draft decides how many target steps are taken, never what they
produce. Batched rows advance in lockstep by the smallest acceptance among
the unfinished rows, so every cache index stays one Python int; the
rollback to the accepted frontier assigns that index on each layer's
self-attention cache (rows past it are stale and are overwritten).

The loop is eager. The acceptance ``n`` and whether every row is done are
read to the host together, once per verify iteration (one sync; the
prefill's done check and the final readback are one more each):
``last_host_syncs`` counts them for the last ``generate``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.generator import search
from ofasys_torch.generator.base import SequenceGeneratorOutput
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device

logger = logging.getLogger("ofasys_torch.speculative")

NEG_INF = search.NEG_INF


def _set_self_index(cache: Dict[str, Any], value: int) -> Dict[str, Any]:
    """Every layer's self-attention cache index set to ``value`` (the rows
    above it are stale and will be overwritten)."""
    return {name: {**layer, "self": {**layer["self"], "index": int(value)}}
            for name, layer in cache.items()}


class SpeculativeGenerator:
    """Greedy-only speculative decoding. ``draft_model`` must share the
    target's vocabulary (the same Dictionary); any smaller arch works — a
    worse draft only lowers acceptance, never changes the output."""

    def __init__(
        self,
        model,                      # target GeneralistModel (initialized)
        draft_model,                # draft GeneralistModel (initialized, same vocab)
        dictionary,
        gamma: int = 4,             # draft tokens proposed per iteration
        max_len_a: float = 0.0,
        max_len_b: int = 200,
        min_len: int = 1,
        lenpen: float = 1.0,
        constraint_range: Optional[str] = None,
    ):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.model = model
        self.draft_model = draft_model
        self.dictionary = dictionary
        self.bos = dictionary.bos()
        self.eos = dictionary.eos()
        self.pad = dictionary.pad()
        self.gamma = gamma
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.lenpen = lenpen
        self.constraint_start = self.constraint_end = None
        if constraint_range:
            lo, hi = constraint_range.strip("() ").split(",")
            self.constraint_start, self.constraint_end = int(lo), int(hi)
        self.last_stats: Dict[str, Any] = {}
        self.last_host_syncs = 0
        # when a list: each verify's rejections, as the target's log-prob
        # margin of its own choice over the draft's token where they part
        self.rejections: Optional[List[float]] = None

    # ----------------------------------------------------------- public API
    @torch.no_grad()
    def generate(self, sample: Dict[str, Any]) -> List[List[SequenceGeneratorOutput]]:
        device = self.model.net.device
        slots = sample["net_input"]["slots"]
        src_slots = slots_to_device([s for s in slots if s.is_src], device)
        tgt_slot = SlotBatch.target_slot(slots)
        src_len = 0
        for s in src_slots:
            x = s.value.get("inputs")
            if x is not None and x.dim() == 2:
                src_len = max(src_len, int(x.shape[1]))
        max_len = int(self.max_len_a * src_len + self.max_len_b)

        self.last_host_syncs = 0
        seqs, scores, iters, L = self._generate(src_slots, tgt_slot, max_len)
        seqs = seqs.cpu().numpy().astype(np.int32)   # one readback
        scores = scores.cpu().numpy()
        self.last_host_syncs += 1
        # tokens emitted vs target forwards taken (the prefill emits 1 token,
        # each verify accepted + 1); the per-verify rates use the loop's
        # tokens (L - 2), and are 0 without a verify (the prefill hit EOS)
        loop_tok = max(L - 2, 0)
        self.last_stats = {
            "tokens": L - 1,
            "target_steps": iters + 1,
            "tokens_per_verify": round(loop_tok / iters, 2) if iters else 0.0,
            "mean_accepted": round(loop_tok / iters - 1.0, 2) if iters else 0.0,
        }
        logger.debug("speculative: %d verify iterations, %d host syncs", iters, self.last_host_syncs)

        out: List[List[SequenceGeneratorOutput]] = []
        for b in range(seqs.shape[0]):
            toks = seqs[b, 1:]  # drop bos
            eos_pos = np.nonzero(toks == self.eos)[0]
            if eos_pos.size:
                toks = toks[: eos_pos[0] + 1]
            out.append([SequenceGeneratorOutput(tokens=toks, score=float(scores[b]))])
        return out

    # ------------------------------------------------------------ the loop
    def _shape(self, lp: torch.Tensor, step: int, max_len: int) -> torch.Tensor:
        """The target's logit transforms, as the greedy SequenceGenerator
        applies them (min length, constraint range, EOS forced at
        ``max_len``), so the speculative output is token-identical."""
        lp = search.apply_min_len(lp, step, self.min_len, self.eos)
        if self.constraint_start is not None:
            lp = search.apply_constraint_range(lp, self.constraint_start, self.constraint_end,
                                               self.eos)
        if step >= max_len:
            lp = torch.full_like(lp, NEG_INF)
            lp[..., self.eos] = 0.0
        return lp

    def _generate(self, src_slots, tgt_slot, max_len: int):
        net, dnet = self.model.net, self.draft_model.net
        G = self.gamma

        enc_t = net.encode(src_slots)
        enc_d = dnet.encode(src_slots)
        B = enc_t.x.shape[0]
        device = enc_t.x.device
        T_buf = max_len + G + 3
        dummy = dataclasses.replace(
            tgt_slot, value={"inputs": torch.zeros((B, T_buf), dtype=torch.long, device=device)})
        bias_t, cross_t, cache_t = net.decode_prepare([dummy], enc_t, T_buf)
        bias_d, cross_d, cache_d = dnet.decode_prepare([dummy], enc_d, T_buf)

        def tstep(cache, tokens, step):
            out, _, cache = net.decode_step(tokens, step, enc_t, bias_t, cross_t, cache, tgt_slot)
            return out.float(), cache

        def dstep(cache, tokens, step):
            out, _, cache = dnet.decode_step(tokens, step, enc_d, bias_d, cross_d, cache, tgt_slot)
            return out.float(), cache

        def pick(logits, step):
            return self._shape(torch.log_softmax(logits, dim=-1), step, max_len).argmax(dim=-1)

        seq = torch.full((B, T_buf), self.pad, dtype=torch.long, device=device)
        seq[:, 0] = self.bos

        # prefill: one plain target step emits token 1 (so L >= 2 and the
        # draft's catch-up window of the last two tokens always exists)
        logits0, cache_t = tstep(cache_t, seq[:, 0:1], 0)
        lp0 = self._shape(torch.log_softmax(logits0[:, -1], dim=-1), 0, max_len)
        t1 = lp0.argmax(dim=-1)
        seq[:, 1] = t1
        logp = lp0.gather(1, t1[:, None])[:, 0]
        done = t1 == self.eos
        all_done = bool(done.all())
        self.last_host_syncs += 1

        # at each iteration's start: target cache index == L - 1, draft's L - 2
        L, iters = 2, 0
        while L < max_len + 2 and not all_done:
            # the draft proposes G tokens (a catch-up window of 2, then 1 by 1)
            dlog, cache_d = dstep(cache_d, seq[:, L - 2:L], L - 2)
            tok = pick(dlog[:, -1], L - 1)
            proposed = [tok]
            for j in range(G - 1):
                dlog, cache_d = dstep(cache_d, tok[:, None], L + j)
                tok = pick(dlog[:, -1], L + j)
                proposed.append(tok)
            drafts = torch.stack(proposed, dim=1)                          # (B, G)

            # the target verifies every proposal in one multi-token step;
            # row j predicts position L + j, i.e. generation step L + j - 1
            vlog, cache_t = tstep(cache_t, torch.cat([seq[:, L - 1:L], drafts], dim=1), L - 1)
            vlp = torch.log_softmax(vlog, dim=-1)
            vlp = torch.stack([self._shape(vlp[:, j], L + j - 1, max_len) for j in range(G + 1)],
                              dim=1)
            greedy = vlp.argmax(dim=-1)                                    # (B, G+1)

            # acceptance: the longest agreeing prefix; lockstep on the minimum
            match = drafts == greedy[:, :G]
            acc = torch.cumprod(match.long(), dim=1).sum(dim=1)            # (B,)
            n = torch.where(done, G, acc).min()
            if self.rejections is not None:
                self._record_rejections(vlp, greedy, drafts, acc, done)

            # the token at offset j (0..n): the draft's for j < n; at j == n
            # the row's own draft if it accepted further, else the correction
            d_ext = torch.cat([drafts, greedy[:, -1:]], dim=1)              # (B, G+1)
            at_n = n.expand(B)[:, None]
            corr = torch.where(acc > n, d_ext.gather(1, at_n)[:, 0], greedy.gather(1, at_n)[:, 0])
            new_done, new_logp = done, logp
            for j in range(G + 1):
                tok_j = torch.where(j < n, d_ext[:, j], corr)
                write = ~done & (j <= n)
                seq[:, L + j] = torch.where(write, tok_j, seq[:, L + j])
                lp_j = vlp[:, j].gather(1, tok_j[:, None])[:, 0]
                new_logp = torch.where(write & ~new_done, new_logp + lp_j, new_logp)
                new_done = new_done | (write & (tok_j == self.eos))
            done, logp = new_done, new_logp

            # the one host read of the iteration: n and whether all are done
            n_host, all_done = torch.stack([n, done.all().long()]).tolist()
            self.last_host_syncs += 1
            # roll the caches back to the accepted frontier
            L = L + n_host + 1
            cache_t = _set_self_index(cache_t, L - 1)
            cache_d = _set_self_index(cache_d, L - 2)
            iters += 1

        # length: tokens up to and including the first EOS (lockstep may
        # write draft tokens past a row's EOS; they are dropped here too)
        toks = seq[:, 1:]
        iseos = toks == self.eos
        lengths = torch.where(iseos.any(dim=1), iseos.long().argmax(dim=1) + 1,
                              (toks != self.pad).sum(dim=1))
        scores = logp / torch.clamp(lengths, min=1).float() ** self.lenpen
        return seq, scores, iters, L

    def _record_rejections(self, vlp, greedy, drafts, acc, done):
        """For each unfinished row that rejected a proposal: the target's
        log-prob of its own choice minus that of the draft's token, at the
        first position where they part."""
        G = drafts.shape[1]
        rows = (~done & (acc < G)).nonzero()[:, 0]
        if rows.numel():
            pos = acc[rows]
            lp = vlp[rows, pos]
            gap = (lp.gather(1, greedy[rows, pos][:, None]) - lp.gather(1, drafts[rows, pos][:, None]))
            self.rejections.extend(gap[:, 0].tolist())
