"""Ensemble decoding: ``SequenceGenerator([m1, m2], ...)`` against
ofasys_tpu's ensemble of the same two parameter sets.

Each member keeps its own KV cache, reordered by the same beam indices; a
step's log-probs are ``logsumexp_i(log_softmax(logits_i / T)) - log n``.
The tiny fp32 model of tests/test_torch_search.py with two perturbed
parameter sets (seeds 1 and 2): tokens equal to ofasys_tpu's, scores rtol
1e-5 (top-k margins above 1e-4 in the JAX run). A one-member ensemble is
the single model's path, bit for bit.
"""

import numpy as np
import pytest

from ofasys_torch.generator import SequenceGenerator

from test_torch_search import (  # noqa: F401  (fixture)
    SRCS, _one_torch_thread, assert_same_hypotheses, jax_generate, make_env, samples,
)


@pytest.fixture(scope="module")
def env2():
    return make_env(seeds=(1, 2))


@pytest.mark.parametrize("opts", [dict(beam_size=3), dict(beam_size=1),
                                  dict(beam_size=4, temperature=0.7, return_n_best=2),
                                  dict(beam_size=2, no_repeat_ngram_size=2, lenpen=0.5)],
                         ids=["beam3", "greedy", "temperature_nbest", "ngram_lenpen"])
def test_two_member_ensemble_matches_jax(env2, monkeypatch, opts):
    opts = dict(opts, max_len_b=10)
    js, ts = samples(env2, [{"src": s} for s in SRCS])
    jout = jax_generate(monkeypatch, env2, js, models=[env2["jm"], env2["jm"]], params=env2["params"],
                        **opts)
    tout = SequenceGenerator(env2["tms"], env2["td"], **opts).generate(ts)
    assert_same_hypotheses(jout, tout)


def test_one_member_ensemble_is_the_model(env2):
    _, ts = samples(env2, [{"src": s} for s in SRCS])
    one = SequenceGenerator([env2["tms"][0]], env2["td"], beam_size=3, max_len_b=10).generate(ts)
    single = SequenceGenerator(env2["tms"][0], env2["td"], beam_size=3, max_len_b=10).generate(ts)
    for a, b in zip(one, single, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x.tokens, y.tokens)
            assert x.score == y.score


def test_two_members_differ_from_either(env2):
    """The ensemble is not one of its members: on some request its tokens
    or scores differ from each member's alone."""
    _, ts = samples(env2, [{"src": s} for s in SRCS])
    both = SequenceGenerator(env2["tms"], env2["td"], beam_size=3, max_len_b=10).generate(ts)
    for m in env2["tms"]:
        alone = SequenceGenerator(m, env2["td"], beam_size=3, max_len_b=10).generate(ts)
        assert any(not np.array_equal(a[0].tokens, b[0].tokens) or a[0].score != b[0].score
                   for a, b in zip(both, alone))
