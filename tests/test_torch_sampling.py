"""Sampling in the port's SequenceGenerator against ofasys_tpu's.

The port draws from a ``torch.Generator`` seeded by ``generate(...,
seed=)``, ofasys_tpu from ``jax.random``: the streams differ, so what is
held equal is what does not depend on them.
  * ``sampling_topk=1``, and ``sampling_topp`` below every row's largest
    probability, leave one token per beam: the tokens are ofasys_tpu's and
    the scores agree to rtol 1e-5 (top-k margins above 1e-4 in the JAX run).
  * The first step's draws of 2,000 identical requests in one batch
    (temperature 4) follow the softmax of the filtered log-probs: a
    chi-square test over the tokens (cells with fewer than 5 expected draws
    pooled) must not reject at p = 1e-3.
  * The same seed gives the same tokens; another seed other tokens.
The tiny fp32 model is tests/test_torch_search.py's.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from ofasys_tpu import OFASys as JOFASys
from ofasys_torch import OFASys
from ofasys_torch.generator import SequenceGenerator, search

from test_torch_search import SRCS, TPL, assert_same_hypotheses, env, jax_generate, samples  # noqa: F401


def _hub(env):
    return OFASys(env["tms"][0], None, env["td"], env["tgp"], device="cpu")


@pytest.mark.parametrize("opts", [
    dict(sampling=True, sampling_topk=1, beam_size=1),
    dict(sampling=True, sampling_topk=1, beam_size=3, return_n_best=2),
    dict(sampling=True, sampling_topp=1e-3, beam_size=2),
], ids=["topk1_greedy", "topk1_beam3", "topp_below_max"])
def test_one_token_filters_match_jax(env, monkeypatch, opts):
    opts = dict(opts, max_len_b=10)
    js, ts = samples(env, [{"src": s} for s in SRCS])
    jout = jax_generate(monkeypatch, env, js, **opts)
    tout = SequenceGenerator(env["tms"][0], env["td"], **opts).generate(ts, seed=3)
    assert_same_hypotheses(jout, tout)


@pytest.mark.parametrize("top_k,top_p", [(8, -1.0), (-1, 0.6), (30, 0.9)])
def test_first_step_draws_follow_the_filtered_softmax(env, monkeypatch, top_k, top_p):
    n = 2000
    _, ts = samples(env, [{"src": SRCS[1]}] * n)
    seen = []
    orig = search.top_k_top_p_filter

    def record(lp, k, p):
        out = orig(lp, k, p)
        seen.append(out)
        return out

    monkeypatch.setattr(search, "top_k_top_p_filter", record)
    # temperature 4 flattens the random model's first step, so that the
    # filtered distribution keeps several tokens with real mass
    gen = SequenceGenerator(env["tms"][0], env["td"], beam_size=1, max_len_b=1, sampling=True,
                            sampling_topk=top_k, sampling_topp=top_p, temperature=4.0)
    out = gen.generate(ts, seed=11)
    lp0 = seen[0]
    assert torch.equal(lp0, lp0[:1].expand_as(lp0))          # every request, the same row
    p = torch.softmax(lp0[0].double(), dim=-1).numpy()
    first = np.asarray([h[0].tokens[0] for h in out])
    support = np.nonzero(p > 0)[0]
    assert np.isin(first, support).all()
    expected = n * p[support]
    counts = np.asarray([(first == t).sum() for t in support], np.float64)
    big = expected >= 5
    f_obs = np.append(counts[big], counts[~big].sum())
    f_exp = np.append(expected[big], expected[~big].sum())
    keep = f_exp > 0
    chi = stats.chisquare(f_obs[keep], f_exp[keep] * f_obs[keep].sum() / f_exp[keep].sum())
    assert chi.pvalue > 1e-3, (chi, f_obs, f_exp)
    assert len(support) > 1


def test_same_seed_same_tokens(env):
    hub = _hub(env)
    recs = [{"src": s} for s in SRCS]
    opts = dict(sampling=True, sampling_topk=20, beam_size=3, max_len_b=10)
    a = hub.inference(TPL, recs, seed=5, **opts)
    b = hub.inference(TPL, recs, seed=5, **opts)
    c = hub.inference(TPL, recs, seed=6, **opts)
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert not all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))
    assert all(np.isfinite(x.score) for x in a)


def test_image_default_on_a_text_target_runs(env):
    """The hub's IMAGE defaults ask for sampling with top-k 256 at beam 5,
    which the generator raised on before it was ported; on a text target
    they now run, as in ofasys_tpu."""
    hub = _hub(env)
    out = hub.inference(TPL, [{"src": s} for s in SRCS], sampling=True, sampling_topk=256,
                        beam_size=5, max_len_b=6)
    jhub = JOFASys(env["jm"], env["params"][0], env["jd"], env["jgp"])
    jout = jhub.inference(TPL, [{"src": s} for s in SRCS], sampling=True, sampling_topk=256,
                          beam_size=5, max_len_b=6)
    assert len(out) == len(jout) == len(SRCS)
    assert all(np.isfinite(o.score) and o.tokens[-1] == env["td"].eos() for o in out)


def test_image_target_needs_image_vqgan(env):
    """An IMAGE target with the hub's IMAGE defaults (sampling, top-k 256)
    no longer stops in the generator: it stops at the image_vqgan
    preprocessor, which names the item that ports it."""
    with pytest.raises(NotImplementedError, match="image_vqgan.*Queue A item 11"):
        _hub(env).inference("[TEXT:src] -> [IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]",
                            {"src": "a cat"})
