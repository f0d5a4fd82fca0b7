"""Beam search over the GeneralistModel (counterpart of
ofasys_tpu/generator/sequence_generator.py).

The loop is a Python ``while`` with the same ``cond`` and ``body`` as
ofasys_tpu's ``lax.while_loop``:

  * the encoder runs once; encoder-out is beam-expanded to B*K rows
  * the decoder KV cache is reordered with one gather per step
  * EOS is forced at the final step, so exactly K finished hypotheses
    always exist
  * vocab shaping (min-len, unk penalty, the closed-set trie, constraint
    range, n-gram blocking, the lexical EOS ban, prefix forcing, the
    sampling filters) are logit transforms from generator/search.py, in
    ofasys_tpu's order
  * the candidate pool follows ``search_strategy``: plain beam (the top
    2K), sampling (one draw per beam from a ``torch.Generator`` seeded by
    ``generate(..., seed=)``), ``diverse_beam``, ``diverse_siblings`` or
    ``lexical`` (the top 2K plus the constraint machine's advancing
    candidates, finishing only once every constraint is met, the alive
    pick protecting one candidate per completion bank)
  * ``model`` may be a list (an ensemble): each member keeps its own KV
    cache, reordered by the same beam indices, and a step's log-probs are
    the log of the members' mean probability

Greedy decode is beam_size=1. Sampling cannot reproduce ofasys_tpu's
PRNG stream: the same seed gives the same tokens here, and the draws
follow the filtered distribution.
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
SEARCH_STRATEGIES = ("beam", "diverse_beam", "diverse_siblings", "lexical")
_top_k = search.top_k


def _full_top_k(x: torch.Tensor, k: int):
    """The plain beam's top-k of its K x V candidates: ``torch.topk``, not
    the stable top-k (see the call)."""
    return torch.topk(x, k, dim=1)


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
        model,                       # GeneralistModel or a list (an ensemble)
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
        sampling: bool = False,
        sampling_topk: int = -1,
        sampling_topp: float = -1.0,
        return_n_best: int = 1,
        constraint_trie=None,
        search_strategy: str = "beam",
        num_groups: int = 2,             # diverse_beam
        diversity_strength: float = 0.5, # diverse_beam Hamming penalty
        diversity_rate: float = 0.5,     # diverse_siblings rank penalty
        constraint_representation: str = "unordered",  # pointer | ordered | unordered
    ):
        if search_strategy not in SEARCH_STRATEGIES:
            raise ValueError(f"unknown search_strategy {search_strategy!r}; expected one of "
                             f"{SEARCH_STRATEGIES}")
        if constraint_representation not in search.REPRESENTATIONS:
            raise ValueError(f"unknown constraint representation: {constraint_representation!r}")
        self.models = list(model) if isinstance(model, (list, tuple)) else [model]
        self.model = self.models[0]
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
        self.sampling = sampling
        self.sampling_topk = sampling_topk
        self.sampling_topp = sampling_topp
        self.return_n_best = max(1, return_n_best)
        self.search_strategy = search_strategy
        self.num_groups = num_groups
        self.diversity_strength = diversity_strength
        self.diversity_rate = diversity_rate
        self.constraint_representation = constraint_representation
        self.constraint_start = self.constraint_end = None
        if constraint_range:
            # both "lo,hi" and "(lo,hi)"
            lo, hi = constraint_range.strip("() ").split(",")
            self.constraint_start, self.constraint_end = int(lo), int(hi)
        # the closed-set trie as tables on the model's device
        self.trie = (search.compile_trie(constraint_trie, len(dictionary), self.bos,
                                         device=self.model.net.device)
                     if constraint_trie is not None else None)

    # ----------------------------------------------------------- public API
    @torch.no_grad()
    def generate(self, sample: Dict[str, Any], prefix_tokens: Optional[np.ndarray] = None,
                 seed: int = 0) -> List[List[SequenceGeneratorOutput]]:
        """Decode a collated sample. ``seed`` seeds the sampling draws;
        ``search_strategy='lexical'`` reads ``sample["constraints"]``, one list
        of token sequences per sample."""
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

        lexical = None
        if self.search_strategy == "lexical":
            raw = sample.get("constraints")
            if raw is None:
                raise ValueError("search_strategy='lexical' needs sample['constraints'] "
                                 "(per-sample lists of token sequences)")
            lexical = search.build_constraints(raw, self.constraint_representation, device)
        gen = torch.Generator(device=device).manual_seed(seed) if self.sampling else None

        seqs, scores = self._generate(src_slots, tgt_slot, prefix, max_len=max_len, min_len=min_len,
                                      generator=gen, lexical=lexical)
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
    def _generate(self, src_slots, tgt_slot, prefix_tokens, *, max_len: int, min_len: int,
                  generator: Optional[torch.Generator] = None, lexical=None):
        K = self.beam_size
        n_models = len(self.models)
        encs, bias_specs, cross_biases, caches = [], [], [], []
        for m in self.models:
            net = m.net
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
            encs.append(enc)
            bias_specs.append(bias_spec)
            cross_biases.append(cross_bias)
            caches.append(cache)
        P = 0 if prefix_tokens is None else prefix_tokens.shape[1]

        seq = torch.full((B, K, T_buf), self.pad, dtype=torch.long, device=device)
        seq[:, :, 0] = self.bos
        alive_lp = torch.tensor([[0.0] + [NEG_INF] * (K - 1)], dtype=torch.float32,
                                device=device).repeat(B, 1)   # only beam 0 alive at start
        fin_seq = torch.zeros_like(seq)
        fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
        fin_flags = torch.zeros((B, K), dtype=torch.bool, device=device)
        rows = torch.arange(N, device=device)
        # one trie state per beam
        tstates = (torch.full((N,), self.trie.initial_state, dtype=torch.long, device=device)
                   if self.trie is not None else None)
        cons, mach = lexical if lexical is not None else (None, None)
        lexstate = mach.init(cons, N) if lexical is not None else None
        log_n = torch.log(torch.tensor(float(n_models)))

        def step_logits(step):
            """One model: the raw last-token logits (the caller applies the
            temperature and log_softmax). An ensemble: the log of the
            members' mean probability."""
            tokens = seq.reshape(N, T_buf)[:, step:step + 1]
            outs = []
            for i, m in enumerate(self.models):
                logits, _, caches[i] = m.net.decode_step(tokens, step, encs[i], bias_specs[i],
                                                         cross_biases[i], caches[i], tgt_slot)
                outs.append(logits[:, -1].float())
            if n_models == 1:
                return outs[0]
            if self.temperature != 1.0:
                outs = [o / self.temperature for o in outs]
            lps = torch.stack([torch.log_softmax(o, dim=-1) for o in outs])
            return torch.logsumexp(lps, dim=0) - log_n.to(lps.device)

        def cond(step):
            best_alive = alive_lp.max(dim=1).values / self._norm(max_len)
            worst_fin = torch.where(fin_flags, fin_scores, NEG_INF).min(dim=1).values
            improvable = torch.any(~fin_flags.all(dim=1) | (best_alive > worst_fin))
            return step <= max_len and bool(improvable)

        step = 0
        while cond(step):
            lp = step_logits(step)
            if n_models == 1:
                if self.temperature != 1.0:
                    lp = lp / self.temperature
                lp = torch.log_softmax(lp, dim=-1)
            V = lp.shape[-1]

            lp = search.apply_min_len(lp, step, min_len, self.eos)
            if self.unkpen:
                lp[:, self.unk] -= self.unkpen
            if self.trie is not None:
                lp = lp + search.trie_allowed_mask(self.trie, tstates, V)
            if self.constraint_start is not None:
                lp = search.apply_constraint_range(lp, self.constraint_start, self.constraint_end,
                                                   self.eos)
            if self.ngram > 0:
                lp = search.block_repeat_ngrams(lp, seq.reshape(N, T_buf), step + 1, self.ngram)
            if lexical is not None:
                # EOS is banned until every constraint is met
                unmet = ~mach.met(cons, lexstate)
                lp[:, self.eos] = torch.where(unmet, NEG_INF, lp[:, self.eos])
            if step == max_len:
                # force EOS at the last step so every beam finishes
                lp = torch.full_like(lp, NEG_INF)
                lp[:, self.eos] = 0.0
            if step < P:
                # force the prefix tokens during the first P steps
                tok = prefix_tokens[:, step].repeat_interleave(K)
                lp = torch.full_like(lp, NEG_INF)
                lp[rows, tok] = 0.0
            if self.sampling:
                lp = search.top_k_top_p_filter(lp, self.sampling_topk, self.sampling_topp)

            lp = lp.reshape(B, K, V)
            cand_lp = alive_lp[:, :, None] + lp                   # (B, K, V)
            flat = cand_lp.reshape(B, K * V)
            cand_banks = None
            if self.sampling:
                # one independent draw per beam; the K beams are the pool
                tok = search.sample_tokens(lp.reshape(N, V), generator).reshape(B, K)
                cand_idx = torch.arange(K, device=device)[None, :] * V + tok
                topk_lp = torch.gather(flat, 1, cand_idx)
                cand_beam, cand_tok = cand_idx // V, cand_idx % V
            elif self.search_strategy == "diverse_beam":
                topk_lp, cand_tok, cand_beam = search.diverse_beam_candidates(
                    lp, alive_lp, self.num_groups, self.diversity_strength)
            elif self.search_strategy == "diverse_siblings":
                topk_lp, cand_tok, cand_beam = search.diverse_siblings_candidates(
                    lp, alive_lp, step, self.diversity_rate)
            elif lexical is not None:
                topk_lp, topk_idx = _top_k(flat, 2 * K)
                cand_beam, cand_tok = topk_idx // V, topk_idx % V
                # the machine's advancing candidates of every beam, duplicates
                # of the top 2K dead
                ext_s, ext_t, ext_b = mach.extension(cons, lexstate, lp, alive_lp)
                dup = ((ext_b[:, :, None] == cand_beam[:, None, :])
                       & (ext_t[:, :, None] == cand_tok[:, None, :])).any(dim=-1)
                ext_s = torch.where(dup, NEG_INF, ext_s)
                topk_lp = torch.cat([topk_lp, ext_s], dim=1)
                cand_beam = torch.cat([cand_beam, ext_b], dim=1)
                cand_tok = torch.cat([cand_tok, ext_t], dim=1)
                # each candidate's state and bank after its token
                M = cand_tok.shape[1]
                flat_rows = (torch.arange(B, device=device)[:, None] * K + cand_beam).reshape(-1)
                cand_adv = mach.advance(cons, search.state_take(lexstate, flat_rows),
                                        cand_tok.reshape(-1))
                cand_banks = mach.bank(cons, cand_adv).reshape(B, M)
            elif self.trie is not None:
                # few allowed tokens: ties below the 2K real candidates matter
                topk_lp, topk_idx = _top_k(flat, 2 * K)
                cand_beam, cand_tok = topk_idx // V, topk_idx % V
            else:
                # the 2K best of K*V candidates: ties here sit at NEG_INF, below
                # at least 2K real candidates, so the fast unstable top-k is exact
                topk_lp, topk_idx = _full_top_k(flat, 2 * K)
                cand_beam, cand_tok = topk_idx // V, topk_idx % V

            # extend sequences
            cand_seq = _take(seq, cand_beam)                       # (B, n_cand, T)
            cand_seq[:, :, step + 1] = cand_tok
            is_eos = cand_tok == self.eos

            # ---- merge newly finished into the finished pool
            cand_scores = topk_lp / self._norm(step + 1)
            can_finish = is_eos
            if cand_banks is not None:
                # a hypothesis finishes only once every constraint is met
                met = torch.gather(mach.met(cons, lexstate).reshape(B, K), 1, cand_beam)
                can_finish = is_eos & met
            new_fin_scores = torch.where(can_finish, cand_scores, NEG_INF)
            all_fin_seq = torch.cat([fin_seq, cand_seq], dim=1)
            all_fin_scores = torch.cat([fin_scores, new_fin_scores], dim=1)
            all_fin_flags = torch.cat([fin_flags, can_finish], dim=1)
            fin_scores, top_fin_idx = _top_k(all_fin_scores, K)
            fin_seq = _take(all_fin_seq, top_fin_idx)
            fin_flags = _take(all_fin_flags, top_fin_idx)

            # ---- pick K alive (non-eos) candidates
            alive_cand_lp = torch.where(is_eos, NEG_INF, topk_lp)
            if cand_banks is not None:
                # dynamic beam allocation: the best candidate of every bank survives
                _, alive_idx = _top_k(search.lex_protect(alive_cand_lp, cand_banks, mach.max_bank), K)
                alive_lp = torch.gather(alive_cand_lp, 1, alive_idx)
            else:
                alive_lp, alive_idx = _top_k(alive_cand_lp, K)
            seq = _take(cand_seq, alive_idx)
            chosen_beam = _take(cand_beam, alive_idx)
            if K > 1:
                caches = [_gather_beams(c, chosen_beam, B, K) for c in caches]
            if self.trie is not None:
                prev = torch.gather(tstates.reshape(B, K), 1, chosen_beam)
                alive_tok = torch.gather(cand_tok, 1, alive_idx)
                tstates = search.trie_advance(self.trie, prev.reshape(N), alive_tok.reshape(N))
            if cand_banks is not None:
                M = cand_tok.shape[1]
                lexstate = search.state_take(
                    cand_adv, (torch.arange(B, device=device)[:, None] * M + alive_idx).reshape(-1))
            step += 1
        return fin_seq, fin_scores
