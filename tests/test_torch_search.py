"""The port's search shaping (ofasys_torch/generator/search.py) and the
decode loop's candidate strategies against ofasys_tpu's.

Pure functions (sampling filters, diverse beam and diverse siblings
candidates) take the same random inputs from a numpy seed on both sides;
their outputs must be equal (tokens, beams and masks exactly, scores to
rtol 1e-6: the same fp32 sums of two or three terms).

Generation: a tiny model (2+2 layers, E=256 with the tiny arch's widths
cut by ``_configure``), fp32, the same perturbed parameters on both sides
(carried with ``load_jax_params``), decoded through SequenceGenerator under
``diverse_beam`` and ``diverse_siblings``: tokens equal, scores rtol 1e-5.
So that a near-tie cannot flip a selection, the JAX run records the margin
at every top-k boundary and the test first asserts that all exceed 1e-4
(tests/test_torch_serving.py asks 1e-3 of its runs; the log-probs of the
two packages agree to about 1e-6 here, so 1e-4 leaves a factor of 100).
This file also holds the shared decode environment of the other
decode-extras tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.generator import search as jsearch
from ofasys_tpu.generator.sequence_generator import SequenceGenerator as JGenerator
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.generator import SequenceGenerator, search
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import load_jax_params

TPL = "[TEXT:src] -> [TEXT:tgt]"
SRCS = ["hello world", "the quick brown fox jumps", "over the lazy dog", "0123456789 abc"]
NEG_INF = -1e9
SCORE_RTOL = 1e-5
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ decode env
def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _configure(m):
    m.cfg.encoder.layers = m.cfg.decoder.layers = 2
    m.cfg.dropout = 0.0


def _perturb(params, seed=1):
    """Sharper logits than the init gives (so beams spread) and random
    tables and biases, as tests/test_torch_serving.py perturbs them."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "kernel":
            return a * 2.0
        if name == "embedding":
            return 0.1 * noise
        if name == "rel_pos_table":
            return 0.5 * noise
        if name == "scale":
            return a + 0.2 * noise
        if name in ("bias", "c_attn", "type_embedding"):
            return a + 0.1 * noise
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def make_env(seeds=(1,), text_setup=None):
    """JAX model + preprocess, one perturbed parameter tree per seed, and a
    port model per tree on the CPU. ``text_setup(jtext, ttext)`` runs on both
    text preprocessors before the models are built (an ans2label table)."""
    jd = _dictionary(JDictionary)
    jgp = JGeneralPreprocess(jd, active=["text"])
    td = _dictionary(Dictionary)
    tgp = GeneralPreprocess(td, active=["text"])
    if text_setup is not None:
        text_setup(jgp.name2pre["text"], tgp.name2pre["text"])
    jm = JModel(arch="tiny")
    _configure(jm)
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    ist = jgp(JInstruction(TPL, split="test").format(src="a b"))
    raw = jm.init_params(jax.random.PRNGKey(0), jgp.collate([ist])["net_input"]["slots"])
    params, tms = [], []
    for seed in seeds:
        p = _perturb(raw, seed)
        tm = GeneralistModel(arch="tiny")
        _configure(tm)
        tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
        load_jax_params(tm.net, p)
        params.append(p)
        tms.append(tm)
    return {"jm": jm, "jd": jd, "jgp": jgp, "params": params, "td": td, "tgp": tgp, "tms": tms}


def samples(env, recs, template=TPL, split="test"):
    """The same records collated by both packages: (JAX sample, port sample)."""
    js = env["jgp"].collate([env["jgp"](JInstruction(template, split=split).format(**r)) for r in recs])
    ts = env["tgp"].collate([env["tgp"](Instruction(template, split=split).format(**r)) for r in recs])
    return js, ts


def recording_top_k(margins):
    """jax.lax.top_k that records, at every call, the gap between the k-th
    value and the next real (not masked) one."""
    orig = jax.lax.top_k

    def top_k(x, k):
        if k >= x.shape[-1]:
            return orig(x, k)
        vals, idx = orig(x, k + 1)

        def record(v):
            v = np.asarray(v)
            kth, nxt = v[..., k - 1], v[..., k]
            real = nxt > NEG_INF / 2
            margins.extend((kth - nxt)[real].tolist())

        jax.debug.callback(record, vals)
        return vals[..., :k], idx[..., :k]

    return top_k


def jax_generate(monkeypatch, env, jsample, models=None, params=None, **opts):
    """ofasys_tpu's SequenceGenerator on ``jsample``, with the top-k margins
    of the run asserted above MARGIN."""
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", recording_top_k(margins))
    gen = JGenerator(models or env["jm"], env["jd"], **opts)
    out = gen.generate(params if params is not None else env["params"][0], jsample)
    monkeypatch.undo()
    # (a sampling run may have no top-k boundary between real candidates)
    assert min(margins, default=np.inf) > MARGIN, f"near-tie in the JAX run: {min(margins)}"
    return out


def assert_same_hypotheses(jout, tout, rtol=SCORE_RTOL):
    for ja, tb in zip(jout, tout, strict=True):
        for a, b in zip(ja, tb, strict=True):
            np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
            np.testing.assert_allclose(b.score, a.score, rtol=rtol)


@pytest.fixture(scope="module")
def env():
    return make_env()


# ------------------------------------------------------- sampling filters
def _lp(seed, N=12, V=97):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((N, V))).astype(np.float32)
    x[0, :5] = NEG_INF               # masked tokens in the row, as the loop passes them
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("top_k,top_p", [(1, -1.0), (5, -1.0), (-1, 0.9), (-1, 0.5), (20, 0.8),
                                         (200, -1.0), (-1, 1.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_top_k_top_p_filter_matches(top_k, top_p, seed):
    lp = _lp(seed)
    want = np.asarray(jsearch.top_k_top_p_filter(jnp.asarray(lp), top_k, top_p)) \
        if top_k <= lp.shape[-1] else None
    got = search.top_k_top_p_filter(torch.tensor(lp.copy()), top_k, top_p).numpy()
    if want is None:   # top_k past V keeps everything
        np.testing.assert_array_equal(got, lp)
        return
    np.testing.assert_array_equal(got, want)


def test_top_p_exact_threshold_keeps_the_reaching_token():
    """Probabilities 1/2, 1/4, 1/8, ... sum exactly: with top_p = 0.75 the
    cumulative sum equals the threshold at the second token, and both sides
    keep exactly the first two (``cum >= top_p``)."""
    p = np.asarray([0.5, 0.25, 0.125, 0.0625, 0.0625], np.float32)
    lp = np.log(p)[None, :].astype(np.float32)
    want = np.asarray(jsearch.top_k_top_p_filter(jnp.asarray(lp), -1, 0.75))
    got = search.top_k_top_p_filter(torch.tensor(lp), -1, 0.75).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, :2] > NEG_INF / 2).all() and (got[0, 2:] == NEG_INF).all()


@pytest.mark.parametrize("V", [16, 50, 300, 5000])
def test_cumsum_follows_xla_order(V):
    """The top-p cumulative sum adds in XLA's CPU order (blocks of 16), so
    it is jnp.cumsum's bit for bit, also where a row lands near top_p."""
    x = np.random.default_rng(V).random((8, V)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(search._xla_cumsum(torch.tensor(x)).numpy(), want)


# ------------------------------------------------------ diverse candidates
def _cand_inputs(seed, B=3, K=4, V=41):
    rng = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((B, K, V)).astype(np.float32))))
    alive = (-rng.random((B, K)) * 3).astype(np.float32)
    alive[0, 1:] = NEG_INF           # step 0: only beam 0 alive
    return lp, alive


def _same_candidates(got, want):
    gs, gt, gb = (t.numpy() for t in got)
    ws, wt, wb = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("G,strength", [(2, 0.5), (4, 1.5), (1, 0.5)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diverse_beam_candidates_match(seed, G, strength):
    lp, alive = _cand_inputs(seed)
    want = jsearch.diverse_beam_candidates(jnp.asarray(lp), jnp.asarray(alive), G, strength)
    got = search.diverse_beam_candidates(torch.tensor(lp), torch.tensor(alive), G, strength)
    _same_candidates(got, want)


def test_diverse_beam_needs_divisible_groups():
    lp, alive = _cand_inputs(0, K=5)
    with pytest.raises(ValueError, match="divisible"):
        jsearch.diverse_beam_candidates(jnp.asarray(lp), jnp.asarray(alive), 2, 0.5)
    with pytest.raises(ValueError, match="divisible"):
        search.diverse_beam_candidates(torch.tensor(lp), torch.tensor(alive), 2, 0.5)


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diverse_siblings_candidates_match(seed, step):
    lp, alive = _cand_inputs(seed)
    want = jsearch.diverse_siblings_candidates(jnp.asarray(lp), jnp.asarray(alive), jnp.int32(step), 0.7)
    got = search.diverse_siblings_candidates(torch.tensor(lp), torch.tensor(alive), step, 0.7)
    _same_candidates(got, want)


# ------------------------------------------------------------ generation
@pytest.mark.parametrize("opts", [
    dict(search_strategy="diverse_beam", beam_size=4, num_groups=2, diversity_strength=0.5),
    dict(search_strategy="diverse_beam", beam_size=4, num_groups=4, diversity_strength=2.0,
         return_n_best=3),
    dict(search_strategy="diverse_siblings", beam_size=3, diversity_rate=0.5, return_n_best=2),
    dict(search_strategy="diverse_siblings", beam_size=4, diversity_rate=1.0, lenpen=0.5),
], ids=["diverse_beam_g2", "diverse_beam_g4_nbest", "siblings_nbest", "siblings_lenpen"])
def test_diverse_generation_matches_jax(env, monkeypatch, opts):
    opts = dict(opts, max_len_b=8)
    js, ts = samples(env, [{"src": s} for s in SRCS])
    jout = jax_generate(monkeypatch, env, js, **opts)
    tout = SequenceGenerator(env["tms"][0], env["td"], **opts).generate(ts)
    assert_same_hypotheses(jout, tout)


def test_unknown_strategy_or_representation_raises(env):
    """An unknown ``constraint_representation`` raises ValueError on both
    sides (ofasys_tpu when it builds the constraints, the port already in
    the constructor). An unknown ``search_strategy`` raises ValueError in
    the port's constructor; ofasys_tpu would run plain beam search."""
    with pytest.raises(ValueError, match="unknown constraint representation"):
        jsearch.build_constraints([[[5]]], "trie")
    with pytest.raises(ValueError, match="unknown constraint representation"):
        SequenceGenerator(env["tms"][0], env["td"], search_strategy="lexical",
                          constraint_representation="trie")
    with pytest.raises(ValueError, match="unknown search_strategy"):
        SequenceGenerator(env["tms"][0], env["td"], search_strategy="nucleus")
