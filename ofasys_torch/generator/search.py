"""Search-space shaping of the decode loop (counterpart of
ofasys_tpu/generator/search.py): logit transforms (min length, constraint
ranges, vocabulary masks, n-gram blocking, the sampling filters), the
candidate pools of diverse beam search and diverse siblings, the
closed-set trie compiled into tables, and the three lexical-constraint
machines with the bank protection of dynamic beam allocation.

Every table is a tensor on the generator's device and every per-beam
state a tensor row, so a decode step moves nothing to or from the host.
Selections follow ``lax.top_k`` (:func:`top_k`: ties to the lower index)
and ``argmax`` (the first maximum), as ofasys_tpu's do.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

NEG_INF = -1e9


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest along the last axis, ties
    broken toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_min_len(log_probs: torch.Tensor, step: int, min_len: int, eos: int) -> torch.Tensor:
    """Disallow EOS before min_len steps."""
    if step < min_len:
        log_probs = log_probs.clone()
        log_probs[..., eos] = NEG_INF
    return log_probs


def apply_constraint_range(log_probs: torch.Tensor, start: int, end: int, eos: int) -> torch.Tensor:
    """Allow only [start, end) plus EOS (the bin or code sub-vocabulary of a
    BOX or image target)."""
    ids = torch.arange(log_probs.shape[-1], device=log_probs.device)
    allowed = ((ids >= start) & (ids < end)) | (ids == eos)
    return apply_vocab_mask(log_probs, allowed)


def apply_vocab_mask(log_probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask: bool (..., V), True = allowed."""
    return torch.where(mask, log_probs, torch.full((), NEG_INF, dtype=log_probs.dtype,
                                                   device=log_probs.device))


def block_repeat_ngrams(
    log_probs: torch.Tensor,     # (N, V)
    tokens: torch.Tensor,        # (N, T) generated so far (garbage beyond step)
    step: int,                   # next position to be generated
    ngram: int,
) -> torch.Tensor:
    """Ban tokens completing an already-seen n-gram: compare every
    historical (n-1)-window to the current suffix and set NEG_INF at the
    tokens that followed matching windows."""
    k = ngram - 1
    if ngram <= 0 or step < k:
        return log_probs
    N, T = tokens.shape
    P = T - k
    nxt = tokens[:, k:]                                            # (N, P) token after each window
    if k > 0:
        suffix = tokens[:, step - k:step]                          # (N, k)
        windows = tokens.unfold(1, k, 1)[:, :P]                    # (N, P, k)
        match = (windows == suffix[:, None, :]).all(dim=-1)        # (N, P)
    else:
        match = torch.ones((N, P), dtype=torch.bool, device=tokens.device)
    # only windows fully inside the generated region: p + k < step
    idx = torch.arange(P, device=tokens.device)
    match = match & ((idx[None, :] + k) < step)
    rows, cols = match.nonzero(as_tuple=True)
    out = log_probs.clone()
    out[rows, nxt[rows, cols]] = NEG_INF
    return out


def length_penalty(length: int, alpha: float) -> float:
    """fairseq-style: score / len**alpha, computed in fp32."""
    return float(torch.tensor(float(max(length, 1)), dtype=torch.float32) ** alpha)


def _xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in the order XLA's CPU
    backend sums ``jnp.cumsum``: blocks of ``base`` summed left to right,
    the blocks' totals scanned the same way recursively, each block's
    exclusive prefix added to its in-block sums."""
    V = x.shape[-1]
    if V <= base:
        out, acc = [], torch.zeros_like(x[..., 0])
        for j in range(V):
            acc = acc + x[..., j]
            out.append(acc)
        return torch.stack(out, dim=-1)
    nb = -(-V // base)
    xp = torch.nn.functional.pad(x, (0, nb * base - V)).reshape(*x.shape[:-1], nb, base)
    inb = _xla_cumsum(xp, base)
    pre = _xla_cumsum(inb[..., -1], base)
    excl = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    return (excl[..., None] + inb).reshape(*x.shape[:-1], nb * base)[..., :V]


def top_k_top_p_filter(log_probs: torch.Tensor, top_k: int = -1, top_p: float = -1.0) -> torch.Tensor:
    """Sampling filters: with ``top_k > 0`` every log-prob below the k-th
    largest of its row becomes NEG_INF; with ``0 < top_p < 1`` every one
    below the smallest of the fewest largest whose probabilities sum to at
    least ``top_p`` (the cumulative sum in XLA's CPU order, the
    probabilities ``exp(x - max) / sum``)."""
    if top_k > 0:
        kth = torch.topk(log_probs, min(top_k, log_probs.shape[-1]), dim=-1).values[..., -1:]
        log_probs = torch.where(log_probs < kth, NEG_INF, log_probs)
    if 0.0 < top_p < 1.0:
        sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
        e = torch.exp(sorted_lp - sorted_lp[..., :1])
        cum = _xla_cumsum(e / e.sum(dim=-1, keepdim=True))
        # the first position whose cumulative probability reaches top_p (0 if none)
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.uint8), dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_lp, -1, cutoff_idx)
        log_probs = torch.where(log_probs < cutoff, NEG_INF, log_probs)
    return log_probs


def sample_tokens(log_probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token per row drawn from ``softmax(log_probs)`` by the Gumbel-max
    trick, as ``jax.random.categorical``: argmax of ``log_probs`` plus
    ``-log(-log(u))`` with u uniform in [tiny, 1) from ``generator``."""
    u = torch.rand(log_probs.shape, generator=generator, device=log_probs.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(log_probs - torch.log(-torch.log(u)), dim=-1)


# ---- candidate pools: (scores, tokens, beams), each (B, M), that the beam
# loop merges into its finished and alive sets; the plain pool is the
# top-2K of alive_lp + lp

def diverse_beam_candidates(lp: torch.Tensor, alive_lp: torch.Tensor, num_groups: int,
                            diversity_strength: float):
    """Hamming-diversity beam search: beams in ``num_groups`` interleaved
    groups (beam i in group i % G); group g's log-probs lose ``strength``
    times the number of times each token was already picked this step by
    the groups before it. Candidates are interleaved by rank across groups."""
    B, K, V = lp.shape
    G = num_groups
    if K % G != 0:
        raise ValueError(f"beam size {K} must be divisible by num_groups {G}")
    Kg = K // G
    k = min(2 * Kg, Kg * V - 1)
    diversity = torch.zeros((B, V), dtype=lp.dtype, device=lp.device)
    ss, tt, bb = [], [], []
    for g in range(G):
        lp_g = lp[:, g::G] + alive_lp[:, g::G, None]
        if g > 0:
            lp_g = lp_g - diversity_strength * diversity[:, None, :]
        s, idx = top_k(lp_g.reshape(B, Kg * V), k)
        toks = idx % V
        diversity = diversity.scatter_add(1, toks, torch.ones_like(s))
        ss.append(s)
        tt.append(toks)
        bb.append((idx // V) * G + g)
    return (torch.stack(ss, -1).reshape(B, -1), torch.stack(tt, -1).reshape(B, -1),
            torch.stack(bb, -1).reshape(B, -1))


def diverse_siblings_candidates(lp: torch.Tensor, alive_lp: torch.Tensor, step: int,
                                diversity_rate: float):
    """Diverse siblings (Li & Jurafsky): each beam's top-k tokens lose their
    rank (1-based) times ``diversity_rate`` before the global top-k, so the
    siblings of one beam compete at a discount. Step 0 is plain beam search."""
    B, K, V = lp.shape
    k = min(2 * K, V - 1)
    s, t = top_k(lp + alive_lp[:, :, None], k)                     # (B, K, k)
    if step != 0:
        s = s - torch.arange(1, k + 1, dtype=s.dtype, device=s.device) * diversity_rate
    fs, fi = top_k(s.reshape(B, K * k), k)
    return fs, torch.gather(t.reshape(B, K * k), 1, fi), fi // k


# ---- lexically constrained decoding (DBA style). Constraints are
# per-sample token sequences that must appear in the output; each beam
# carries its machine's state, and the alive pick protects the best
# candidate of every completion bank (Post & Vilar's dynamic beam
# allocation).

def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def _rows_to_sample(n_rows: int, batch: int, device) -> torch.Tensor:
    """Row -> sample index for (B, k)-grouped flattened rows."""
    return torch.arange(n_rows, device=device) // (n_rows // batch)


class LexicalConstraints(NamedTuple):
    tokens: torch.Tensor    # (B, C, L), -1 padded
    lengths: torch.Tensor   # (B, C)

    @staticmethod
    def build(batch_constraints, device=None) -> Tuple["LexicalConstraints", int]:
        """Per-sample lists of token sequences -> (tables, max_bank)."""
        B = len(batch_constraints)
        C = max((len(c) for c in batch_constraints), default=1) or 1
        L = max((len(s) for c in batch_constraints for s in c), default=1) or 1
        toks = np.full((B, C, L), -1, np.int64)
        lens = np.zeros((B, C), np.int64)
        for b, cons in enumerate(batch_constraints):
            for c, seq in enumerate(cons):
                toks[b, c, : len(seq)] = np.asarray(seq, np.int64)
                lens[b, c] = len(seq)
        return (LexicalConstraints(_long(toks, device), _long(lens, device)),
                int(lens.sum(axis=1).max()))


def _lex_expected(cons: LexicalConstraints, ptr: torch.Tensor, beam_size: int):
    """Next expected token per (beam, constraint); -1 when completed."""
    N, C = ptr.shape
    b_idx = torch.arange(N, device=ptr.device) // beam_size
    toks = cons.tokens[b_idx]                                  # (N, C, L)
    lens = cons.lengths[b_idx]                                 # (N, C)
    safe = torch.minimum(ptr, (lens - 1).clamp_min(0))
    cur = torch.gather(toks, 2, safe[:, :, None])[:, :, 0]
    done = ptr >= lens
    return torch.where(done, -1, cur), done, toks, lens


def lex_advance(cons: LexicalConstraints, ptr: torch.Tensor, chosen: torch.Tensor,
                beam_size: int) -> torch.Tensor:
    """Advance the per-beam constraint pointers by the chosen token: a
    match moves on; a mismatch mid-constraint restarts (at 1 if the token
    starts the constraint, else 0); completed constraints stay completed."""
    cur, done, toks, _ = _lex_expected(cons, ptr, beam_size)
    match = (chosen[:, None] == cur) & ~done
    restart = (chosen[:, None] == toks[:, :, 0]).long()
    return torch.where(done, ptr, torch.where(match, ptr + 1, restart))


def lex_bank(cons: LexicalConstraints, ptr: torch.Tensor, beam_size: int) -> torch.Tensor:
    """Completed constraint tokens per beam (its DBA bank)."""
    lens = cons.lengths[torch.arange(ptr.shape[0], device=ptr.device) // beam_size]
    return torch.minimum(ptr, lens).sum(dim=1)


def lex_candidate_extension(cons: LexicalConstraints, ptr: torch.Tensor, lp: torch.Tensor,
                            alive_lp: torch.Tensor, beam_size: int):
    """Per-beam constraint-advancing candidates (B, K*C): scores, tokens,
    beams, appended to the top-2K pool so that bank protection can keep
    them alive."""
    B, K, V = lp.shape
    cur, _, _, _ = _lex_expected(cons, ptr, beam_size)
    cur2 = cur.reshape(B, K, -1)
    C = cur2.shape[-1]
    safe_tok = cur2.clamp_min(0)
    s = torch.gather(lp, 2, safe_tok) + alive_lp[:, :, None]
    s = torch.where(cur2 < 0, NEG_INF, s)
    beams = torch.arange(K, device=lp.device)[None, :, None].expand(B, K, C)
    return s.reshape(B, K * C), safe_tok.reshape(B, K * C), beams.reshape(B, K * C)


def lex_protect(scores: torch.Tensor, banks: torch.Tensor, max_bank: int) -> torch.Tensor:
    """The DBA selection key: the best candidate of every non-empty bank
    gains 1e6, so one hypothesis per completion level survives the alive
    top-K. ``scores`` (B, M) has its EOS candidates at NEG_INF already."""
    n_banks = max_bank + 1
    bank_mask = banks[:, :, None] == torch.arange(n_banks, device=banks.device)
    per_bank = torch.where(bank_mask, scores[:, :, None], NEG_INF)   # (B, M, n_banks)
    best = torch.argmax(per_bank, dim=1)                             # (B, n_banks)
    has_any = per_bank.max(dim=1).values > NEG_INF / 2
    hit = torch.nn.functional.one_hot(best, scores.shape[1]).bool() & has_any[:, :, None]
    protected = hit.any(dim=1)
    return torch.where(protected & (scores > NEG_INF / 2), scores + 1e6, scores)


# ---- the closed-set trie as tables: states with few children hold them in
# a padded (S, Km) children table, high-fanout states (the root, typically)
# a dense (V,) row; one int state per beam

class CompiledTrie(NamedTuple):
    tok: torch.Tensor            # (S+1, Km) children tokens, -1 pad; row S = dead state
    nxt: torch.Tensor            # (S+1, Km) child state ids
    dense_idx: torch.Tensor      # (S+1,) row into the dense tables, -1 if sparse
    dense_allowed: torch.Tensor  # (D, V) bool
    dense_next: torch.Tensor     # (D, V)
    initial_state: int           # the state after consuming BOS
    num_states: int              # S


def compile_trie(trie, vocab_size: int, bos: int, dense_threshold: int = 64,
                 device=None) -> CompiledTrie:
    """Flatten a utils.trie.Trie (whose sequences are [bos] + answer +
    [eos]) into tables on ``device``; states are numbered breadth first."""
    nodes = [trie.root]
    ids = {id(trie.root): 0}
    i = 0
    while i < len(nodes):
        for child in nodes[i].values():
            if id(child) not in ids:
                ids[id(child)] = len(nodes)
                nodes.append(child)
        i += 1
    S = len(nodes)
    DEAD = S
    children = [sorted((int(t), ids[id(c)]) for t, c in n.items()) for n in nodes]
    Km = max([len(c) for c in children if len(c) <= dense_threshold], default=1) or 1
    tok = np.full((S + 1, Km), -1, np.int64)
    nxt = np.full((S + 1, Km), DEAD, np.int64)
    dense_idx = np.full((S + 1,), -1, np.int64)
    allowed_rows, next_rows = [], []
    for s, ch in enumerate(children):
        if len(ch) > dense_threshold:
            allowed = np.zeros((vocab_size,), bool)
            nxt_row = np.full((vocab_size,), DEAD, np.int64)
            for t, c in ch:
                allowed[t] = True
                nxt_row[t] = c
            dense_idx[s] = len(allowed_rows)
            allowed_rows.append(allowed)
            next_rows.append(nxt_row)
        else:
            for j, (t, c) in enumerate(ch):
                tok[s, j] = t
                nxt[s, j] = c
    if not allowed_rows:   # keep the gathers shape-valid
        allowed_rows.append(np.zeros((vocab_size,), bool))
        next_rows.append(np.full((vocab_size,), DEAD, np.int64))
    init = next((c for t, c in children[0] if t == bos), DEAD)
    return CompiledTrie(
        tok=_long(tok, device), nxt=_long(nxt, device), dense_idx=_long(dense_idx, device),
        dense_allowed=torch.as_tensor(np.stack(allowed_rows), device=device),
        dense_next=_long(np.stack(next_rows), device), initial_state=int(init), num_states=S,
    )


def trie_allowed_mask(ct: CompiledTrie, states: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(N,) beam states -> (N, V) additive fp32 mask: 0 allowed, NEG_INF not."""
    N = states.shape[0]
    t = ct.tok[states]                                           # (N, Km)
    safe = torch.where(t >= 0, t, vocab_size)                    # pads land in a dropped column
    mask = torch.full((N, vocab_size + 1), NEG_INF, dtype=torch.float32, device=states.device)
    mask = mask.scatter(1, safe, 0.0)[:, :vocab_size]
    di = ct.dense_idx[states]
    dmask = torch.where(ct.dense_allowed[di.clamp_min(0)], 0.0, NEG_INF)
    return torch.where((di >= 0)[:, None], dmask, mask)


def trie_advance(ct: CompiledTrie, states: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Each beam's state after its chosen token (off the trie: the dead state)."""
    t = ct.tok[states]
    eq = t == tokens[:, None]
    j = torch.argmax(eq.to(torch.uint8), dim=1)
    sparse_next = torch.where(eq.any(dim=1), torch.gather(ct.nxt[states], 1, j[:, None])[:, 0],
                              ct.num_states)
    di = ct.dense_idx[states]
    dense_next = torch.gather(ct.dense_next[di.clamp_min(0)], 1, tokens[:, None])[:, 0]
    return torch.where(di >= 0, dense_next, sparse_next)


# ---- the three lexical-constraint machines: "pointer" (one progress
# pointer per constraint), "ordered" (constraints in the given order: one
# pointer into their concatenation) and "unordered" (any order, through a
# per-sample trie of the constraints with generated / completed counts)

def state_take(state, idx: torch.Tensor):
    """Reorder per-beam constraint-state rows by flat indices."""
    if isinstance(state, torch.Tensor):
        return state[idx]
    return type(state)(*(a[idx] for a in state))


class OrderedConstraints(NamedTuple):
    seq: torch.Tensor        # (B, L) the constraints concatenated, -1 padded
    endpoints: torch.Tensor  # (B, L) bool: the position ends a constraint
    total: torch.Tensor      # (B,) constraint tokens

    @staticmethod
    def build(batch_constraints, device=None) -> Tuple["OrderedConstraints", int]:
        B = len(batch_constraints)
        L = max((sum(len(s) for s in c) for c in batch_constraints), default=1) or 1
        seq = np.full((B, L), -1, np.int64)
        ends = np.zeros((B, L), bool)
        total = np.zeros((B,), np.int64)
        for b, cons in enumerate(batch_constraints):
            pos = 0
            for s in cons:
                seq[b, pos: pos + len(s)] = np.asarray(s, np.int64)
                ends[b, pos + len(s) - 1] = True
                pos += len(s)
            total[b] = pos
        return (OrderedConstraints(_long(seq, device), torch.as_tensor(ends, device=device),
                                   _long(total, device)), int(total.max()))


def ord_advance(oc: OrderedConstraints, ptr: torch.Tensor, tokens: torch.Tensor,
                batch: int) -> torch.Tensor:
    """Finished -> stay; the next token matched -> +1; at a constraint's end
    (or the root) -> stay; the first token -> restart at 0; else the root (-1)."""
    b = _rows_to_sample(ptr.shape[0], batch, ptr.device)
    L = oc.seq.shape[1]
    fin = ptr + 1 >= oc.total[b]
    match = ~fin & (tokens == oc.seq[b, (ptr + 1).clamp(0, L - 1)])
    cur_ep = torch.where(ptr < 0, True, oc.endpoints[b, ptr.clamp(0, L - 1)])
    restart = torch.where(tokens == oc.seq[b, 0], 0, -1)
    return torch.where(fin, ptr, torch.where(match, ptr + 1, torch.where(cur_ep, ptr, restart)))


class UnorderedTrieConstraints(NamedTuple):
    """Per-sample constraint tries padded to one (S, Km) shape; node 0 is
    the root."""

    ctok: torch.Tensor      # (B, S, Km) child tokens, -1 padded
    cnxt: torch.Tensor      # (B, S, Km) child node ids
    parent: torch.Tensor    # (B, S) parent node (root -> 0)
    terminal: torch.Tensor  # (B, S) constraints ending exactly here
    subtree: torch.Tensor   # (B, S) constraints through the node
    n_cons: torch.Tensor    # (B,) constraints of the sample

    @staticmethod
    def build(batch_constraints, device=None) -> Tuple["UnorderedTrieConstraints", int, int, int]:
        """-> (tables, max_bank, depth, Km)."""
        B = len(batch_constraints)
        tries = []
        for cons in batch_constraints:
            nodes = [{"ch": {}, "par": 0, "term": 0, "sub": 0, "d": 0}]
            for s in cons:
                cur = 0
                for t in s:
                    t = int(t)
                    if t not in nodes[cur]["ch"]:
                        nodes.append({"ch": {}, "par": cur, "term": 0, "sub": 0,
                                      "d": nodes[cur]["d"] + 1})
                        nodes[cur]["ch"][t] = len(nodes) - 1
                    cur = nodes[cur]["ch"][t]
                nodes[cur]["term"] += 1
                while True:   # constraints through each node of the path, the root included
                    nodes[cur]["sub"] += 1
                    if cur == 0:
                        break
                    cur = nodes[cur]["par"]
            tries.append(nodes)
        S = max(len(n) for n in tries)
        Km = max((len(nd["ch"]) for n in tries for nd in n), default=1) or 1
        depth = max((nd["d"] for n in tries for nd in n), default=1) or 1
        ctok = np.full((B, S, Km), -1, np.int64)
        cnxt = np.zeros((B, S, Km), np.int64)
        parent, terminal, subtree = (np.zeros((B, S), np.int64) for _ in range(3))
        n_cons = np.zeros((B,), np.int64)
        for b, nodes in enumerate(tries):
            n_cons[b] = len(batch_constraints[b])
            for i, nd in enumerate(nodes):
                parent[b, i], terminal[b, i], subtree[b, i] = nd["par"], nd["term"], nd["sub"]
                for j, (t, c) in enumerate(sorted(nd["ch"].items())):
                    ctok[b, i, j] = t
                    cnxt[b, i, j] = c
        max_bank = int(max((sum(len(s) for s in c) for c in batch_constraints), default=0))
        tables = UnorderedTrieConstraints(*(_long(a, device) for a in
                                            (ctok, cnxt, parent, terminal, subtree, n_cons)))
        return tables, max_bank, depth, Km


class UnorderedTrieState(NamedTuple):
    node: torch.Tensor   # (M,) current trie node
    gen: torch.Tensor    # (M, S) generated count per node
    comp: torch.Tensor   # (M, S) completed count per node


def unord_init(ut: UnorderedTrieConstraints, n_rows: int) -> UnorderedTrieState:
    S = ut.parent.shape[1]
    dev = ut.parent.device
    return UnorderedTrieState(torch.zeros((n_rows,), dtype=torch.long, device=dev),
                              torch.zeros((n_rows, S), dtype=torch.long, device=dev),
                              torch.zeros((n_rows, S), dtype=torch.long, device=dev))


def unord_advance(ut: UnorderedTrieConstraints, st: UnorderedTrieState, tokens: torch.Tensor,
                  batch: int, depth: int) -> UnorderedTrieState:
    """(1) a matching child that is not saturated -> descend, generated
    count + 1; (2) otherwise fall off: to the matching root child if it is
    not saturated, else the root, and rewind the abandoned path: the first
    ancestor that is an uncompleted terminal gets completed + 1 (and the
    rewind stops), every ancestor before it generated - 1."""
    M = tokens.shape[0]
    rows = torch.arange(M, device=tokens.device)
    b = _rows_to_sample(M, batch, tokens.device)
    cur, gen, comp = st.node, st.gen.clone(), st.comp.clone()

    def child_of(node):
        ct = ut.ctok[b, node]
        match = (ct == tokens[:, None]) & (ct >= 0)
        child = ut.cnxt[b, node, torch.argmax(match.to(torch.uint8), dim=1)]
        return child, match.any(dim=1) & (gen[rows, child] < ut.subtree[b, child])

    child, child_ok = child_of(cur)
    rchild, root_ok = child_of(torch.zeros_like(cur))
    new_node = torch.where(child_ok, child, torch.where(root_ok, rchild, 0))
    falls = ~child_ok
    c, stopped = cur, torch.zeros_like(falls)
    for _ in range(depth):
        active = falls & (c != 0) & ~stopped
        can_complete = ut.terminal[b, c] > comp[rows, c]
        do_complete = active & can_complete
        comp[rows, c] += do_complete.long()
        do_decr = active & ~can_complete
        gen[rows, c] -= do_decr.long()
        c = torch.where(do_decr, ut.parent[b, c], c)
        stopped = stopped | do_complete
    gen[rows, new_node] += (new_node != 0).long()
    return UnorderedTrieState(new_node, gen, comp)


def unord_num_completed(ut: UnorderedTrieConstraints, st: UnorderedTrieState,
                        batch: int) -> torch.Tensor:
    """Completed constraints, the current node's when it ends one included."""
    M = st.node.shape[0]
    rows = torch.arange(M, device=st.node.device)
    b = _rows_to_sample(M, batch, st.node.device)
    in_final = (ut.terminal[b, st.node] > st.comp[rows, st.node]) & (st.node != 0)
    return st.comp.sum(dim=1) + in_final.long()


@dataclasses.dataclass(frozen=True)
class PointerMachine:
    """One progress pointer per constraint (the lex_* functions)."""

    batch: int
    max_bank: int

    def init(self, t: LexicalConstraints, n_rows: int):
        return torch.zeros((n_rows, t.lengths.shape[1]), dtype=torch.long, device=t.lengths.device)

    def advance(self, t, ptr, tokens):
        return lex_advance(t, ptr, tokens, ptr.shape[0] // self.batch)

    def bank(self, t, ptr):
        return lex_bank(t, ptr, ptr.shape[0] // self.batch)

    def met(self, t, ptr):
        b = _rows_to_sample(ptr.shape[0], self.batch, ptr.device)
        return self.bank(t, ptr) >= t.lengths.sum(dim=1)[b]

    def extension(self, t, ptr, lp, alive_lp):
        return lex_candidate_extension(t, ptr, lp, alive_lp, lp.shape[1])


@dataclasses.dataclass(frozen=True)
class OrderedMachine:
    batch: int
    max_bank: int

    def init(self, t: OrderedConstraints, n_rows: int):
        return torch.full((n_rows,), -1, dtype=torch.long, device=t.seq.device)

    def advance(self, t, ptr, tokens):
        return ord_advance(t, ptr, tokens, self.batch)

    def bank(self, t, ptr):
        return ptr + 1

    def met(self, t, ptr):
        b = _rows_to_sample(ptr.shape[0], self.batch, ptr.device)
        return ptr + 1 >= t.total[b]

    def extension(self, t, ptr, lp, alive_lp):
        """Two advancing candidates per beam: the next expected token and,
        mid-sequence, the restart token seq[0]."""
        B, K, V = lp.shape
        L = t.seq.shape[1]
        b = _rows_to_sample(ptr.shape[0], self.batch, ptr.device)
        fin = ptr + 1 >= t.total[b]
        nxt = t.seq[b, (ptr + 1).clamp(0, L - 1)]
        first = t.seq[b, 0]
        toks = torch.stack([torch.where(fin, 0, nxt.clamp_min(0)), first.clamp_min(0)],
                           dim=1).reshape(B, K * 2)
        valid = torch.stack([~fin, (ptr > 0) & (t.total[b] > 0)], dim=1)
        s = torch.gather(lp, 2, toks.reshape(B, K, 2)) + alive_lp[:, :, None]
        s = torch.where(valid.reshape(B, K, 2), s, NEG_INF).reshape(B, K * 2)
        beams = torch.arange(K, device=lp.device)[None, :, None].expand(B, K, 2)
        return s, toks, beams.reshape(B, K * 2)


@dataclasses.dataclass(frozen=True)
class UnorderedMachine:
    batch: int
    max_bank: int
    depth: int
    fanout: int

    def init(self, t: UnorderedTrieConstraints, n_rows: int):
        return unord_init(t, n_rows)

    def advance(self, t, st, tokens):
        return unord_advance(t, st, tokens, self.batch, self.depth)

    def bank(self, t, st):
        return st.gen.sum(dim=1)

    def met(self, t, st):
        b = _rows_to_sample(st.node.shape[0], self.batch, st.node.device)
        return unord_num_completed(t, st, self.batch) >= t.n_cons[b]

    def extension(self, t, st, lp, alive_lp):
        """Advancing candidates per beam: the current node's children and the
        root's, saturated subtrees left out, root children that repeat a
        node child dropped."""
        B, K, V = lp.shape
        M = st.node.shape[0]
        rows = torch.arange(M, device=lp.device)
        b = _rows_to_sample(M, self.batch, lp.device)
        Km = self.fanout
        toks = torch.cat([t.ctok[b, st.node], t.ctok[b, 0]], dim=1)     # (M, 2Km)
        nodes = torch.cat([t.cnxt[b, st.node], t.cnxt[b, 0]], dim=1)
        valid = (toks >= 0) & (st.gen[rows[:, None], nodes] < t.subtree[b[:, None], nodes])
        dup = (toks[:, Km:, None] == toks[:, None, :Km]).any(dim=2) & (toks[:, Km:] >= 0)
        valid = torch.cat([valid[:, :Km], valid[:, Km:] & ~dup], dim=1)
        safe = toks.clamp_min(0).reshape(B, K, 2 * Km)
        s = torch.gather(lp, 2, safe) + alive_lp[:, :, None]
        s = torch.where(valid.reshape(B, K, 2 * Km), s, NEG_INF).reshape(B, K * 2 * Km)
        beams = torch.arange(K, device=lp.device)[None, :, None].expand(B, K, 2 * Km)
        return s, safe.reshape(B, K * 2 * Km), beams.reshape(B, K * 2 * Km)


REPRESENTATIONS = ("pointer", "ordered", "unordered")


def build_constraints(batch_constraints, representation: str, device=None):
    """-> (tables on ``device``, machine)."""
    B = len(batch_constraints)
    if representation == "pointer":
        tables, max_bank = LexicalConstraints.build(batch_constraints, device)
        return tables, PointerMachine(batch=B, max_bank=max_bank)
    if representation == "ordered":
        tables, max_bank = OrderedConstraints.build(batch_constraints, device)
        return tables, OrderedMachine(batch=B, max_bank=max_bank)
    if representation == "unordered":
        tables, max_bank, depth, Km = UnorderedTrieConstraints.build(batch_constraints, device)
        return tables, UnorderedMachine(batch=B, max_bank=max_bank, depth=depth, fanout=Km)
    raise ValueError(f"unknown constraint representation: {representation!r}")
