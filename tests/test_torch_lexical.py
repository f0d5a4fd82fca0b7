"""Lexically constrained decoding: the port's three constraint machines
(pointer, ordered, unordered), DBA bank protection and the ``lexical``
search strategy against ofasys_tpu's.

Machines: the same constraints and the same random walk of chosen tokens
(half of them drawn from the constraints, so the machines advance,
restart and complete) on both sides; every step's state, bank and ``met``
must be equal, and the extension candidates (scores rtol 1e-6, tokens and
beams exactly) on random log-probs. ``lex_protect`` on random scores and
banks: equal keys.

Generation: the tiny fp32 model of tests/test_torch_search.py with 1-2
constraints of 1-2 tokens per sample under each representation: tokens
equal to ofasys_tpu's, scores rtol 1e-5 (top-k margins above 1e-4 in the
JAX run), and every returned hypothesis holds its constraints (in order
under ``ordered``); a slot of the n-best list that no hypothesis filled
(score -1e9) is left out of that check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.generator import search as jsearch
from ofasys_torch.generator import SequenceGenerator, search

from test_torch_search import (  # noqa: F401  (fixtures)
    SRCS, _one_torch_thread, assert_same_hypotheses, env, jax_generate, samples,
)

REPRESENTATIONS = ["pointer", "ordered", "unordered"]
CONSTRAINTS = [[[5, 6], [7]], [[8, 9, 10]], [[5], [6, 7], [5, 8]]]
B, K, V = 3, 4, 16


def _state_np(st):
    if isinstance(st, tuple):
        return [np.asarray(a) for a in st]
    return [np.asarray(st)]


def _state_t(st):
    if isinstance(st, tuple):
        return [a.numpy() for a in st]
    return [st.numpy()]


@pytest.mark.parametrize("rep", REPRESENTATIONS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_machines_match(rep, seed):
    rng = np.random.default_rng(seed)
    jc, jm = jsearch.build_constraints(CONSTRAINTS, rep)
    tc, tm = search.build_constraints(CONSTRAINTS, rep)
    assert jm.max_bank == tm.max_bank
    N = B * K
    jst, tst = jm.init(jc, N), tm.init(tc, N)
    pool = np.asarray(sorted({t for c in CONSTRAINTS for s in c for t in s}))
    for step in range(12):
        lp = np.log(rng.dirichlet(np.ones(V), size=(B, K))).astype(np.float32)
        alive = (-rng.random((B, K)) * 2).astype(np.float32)
        ws, wt, wb = (np.asarray(a) for a in jm.extension(jc, jst, jnp.asarray(lp), jnp.asarray(alive)))
        gs, gt, gb = (a.numpy() for a in tm.extension(tc, tst, torch.tensor(lp), torch.tensor(alive)))
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_allclose(gs, ws, rtol=1e-6)
        toks = np.where(rng.random(N) < 0.5, rng.choice(pool, N), rng.integers(0, V, N))
        jst = jm.advance(jc, jst, jnp.asarray(toks, jnp.int32))
        tst = tm.advance(tc, tst, torch.tensor(toks))
        for a, b in zip(_state_t(tst), _state_np(jst), strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tm.bank(tc, tst).numpy(), np.asarray(jm.bank(jc, jst)))
        np.testing.assert_array_equal(tm.met(tc, tst).numpy(), np.asarray(jm.met(jc, jst)))
    # the walk met some constraints and left others unmet
    met = tm.met(tc, tst).numpy()
    assert met.any() or step == 11


@pytest.mark.parametrize("seed", [0, 1])
def test_state_take_reorders_rows(seed):
    rng = np.random.default_rng(seed)
    tc, tm = search.build_constraints(CONSTRAINTS, "unordered")
    st = tm.advance(tc, tm.init(tc, B * K), torch.tensor(rng.integers(4, 11, B * K)))
    idx = torch.tensor(rng.integers(0, B * K, B * K))
    taken = search.state_take(st, idx)
    for a, b in zip(taken, st):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[idx.numpy()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lex_protect_matches(seed):
    rng = np.random.default_rng(seed)
    M, max_bank = 11, 4
    scores = (-rng.random((B, M)) * 5).astype(np.float32)
    scores[rng.random((B, M)) < 0.3] = -1e9
    banks = rng.integers(0, max_bank + 1, (B, M))
    want = np.asarray(jsearch.lex_protect(jnp.asarray(scores), jnp.asarray(banks, jnp.int32), max_bank))
    got = search.lex_protect(torch.tensor(scores), torch.tensor(banks), max_bank).numpy()
    np.testing.assert_array_equal(got, want)


def _contains(seq, sub):
    return any(list(seq[i:i + len(sub)]) == list(sub) for i in range(len(seq) - len(sub) + 1))


def _constraints(env, seed, n):
    """1-2 constraints of 1-2 byte tokens per sample (a letter, or a space
    and a letter). With longer ones the random model rarely meets them all
    before the length limit, and the check below would see few finished
    hypotheses."""
    rng = np.random.default_rng(seed)
    text = env["tgp"].name2pre["text"]
    words = ["b", "x", "e", "d", "o", "z"]
    return [[text.encode(str(rng.choice(words))).tolist()[-int(rng.integers(1, 3)):]
             for _ in range(int(rng.integers(1, 3)))] for _ in range(n)]


@pytest.mark.parametrize("beam", [4, 5])
@pytest.mark.parametrize("rep", REPRESENTATIONS)
def test_lexical_generation_matches_jax(env, monkeypatch, rep, beam):
    recs = [{"src": s} for s in SRCS]
    js, ts = samples(env, recs)
    cons = _constraints(env, beam, len(recs))
    js["constraints"] = ts["constraints"] = cons
    opts = dict(search_strategy="lexical", constraint_representation=rep, beam_size=beam,
                max_len_b=14, return_n_best=2)
    jout = jax_generate(monkeypatch, env, js, **opts)
    tout = SequenceGenerator(env["tms"][0], env["td"], **opts).generate(ts)
    assert_same_hypotheses(jout, tout)
    n_finished = 0
    for hyps, c in zip(tout, cons):
        for h in hyps:
            if h.score < -1e8:     # a slot of the finished pool that no hypothesis filled
                continue
            n_finished += 1
            assert all(_contains(h.tokens, s) for s in c), (h.tokens, c)
            if rep == "ordered":
                flat = [t for s in c for t in s]
                it = iter(h.tokens.tolist())
                assert all(t in it for t in flat)
    assert n_finished >= 2


def test_lexical_needs_constraints(env):
    _, ts = samples(env, [{"src": "a"}])
    with pytest.raises(ValueError, match="constraints"):
        SequenceGenerator(env["tms"][0], env["td"], search_strategy="lexical").generate(ts)
