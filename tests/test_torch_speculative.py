"""The port's speculative decoding (ofasys_torch/generator/speculative.py)
and ``OFASys.set_draft`` against ofasys_tpu's.

A tiny target (2+2 layers) and a 1-layer draft, fp32, with ofasys_tpu's
init perturbed as tests/test_torch_search.py perturbs it (sharper logits,
random tables and biases) and the decoder layers' output projections
scaled by 10 (else every source decodes to BOS repeated), carried into the port (``load_jax_params``), decode the same
sources on both sides: tokens and ``last_stats`` equal, scores within 1e-5
(relative; sums of a dozen fp32 log-probs taken in the same order). The
sources are the first seeded batch of four in which one row's greedy decode
ends before max_len and another's runs to it, so the lockstep writes past
an early EOS are exercised.

The exactness rule: the port's tokens equal the target's own greedy decode
(argmax at every step, with the same shaping, until EOS), computed here
step by step. They equal the port's ``SequenceGenerator`` at beam 1 too,
except where that search parts from the greedy path at a step where one of
the two takes EOS (the beam keeps its second candidate alive beside a
finished one) and ends with a better length-normalized score: a beam of
one is a search, not greedy decoding, in both packages. The target's verify
step (gamma + 1 tokens at once, at an offset into the cache) is held
against the same number of single steps to 2e-5, as ofasys_tpu's own test
holds its multi-token step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JModality
from ofasys_tpu.generator import SpeculativeGenerator as JSpeculative
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, ModalityType, OFASys
from ofasys_torch.generator import SequenceGenerator, SpeculativeGenerator, search
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import load_jax_params
from ofasys_torch.utils.pytree import SlotBatch

from test_torch_search import _perturb

SCORE_RTOL = 1e-5
STEP_TOL = 2e-5
MAX_LEN_B = 12
TPL = "[TEXT:src] -> [TEXT:tgt]"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dict(cls, n=60):
    d = cls()
    for i in range(n):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _tokens(d, B, Ts, seed):
    r = np.random.default_rng(seed)
    return r.integers(d.nspecial, d.nspecial + 50, size=(B, Ts)).astype(np.int32)


def _jsample(toks):
    B = toks.shape[0]
    return {"net_input": {"slots": [
        JSlotBatch(JModality.TEXT, True, {"inputs": jnp.asarray(toks)}, "src"),
        JSlotBatch(JModality.TEXT, False, {"inputs": jnp.zeros((B, 4), jnp.int32)}, "tgt")]}}


def _tsample(toks):
    B = toks.shape[0]
    return {"net_input": {"slots": [
        SlotBatch(ModalityType.TEXT, True, {"inputs": toks.astype(np.int64)}, "src"),
        SlotBatch(ModalityType.TEXT, False, {"inputs": np.zeros((B, 4), np.int64)}, "tgt")]}}


def _louder_decoder(params, factor=10.0):
    """The decoder layers' output projections (fc2, out_proj) scaled up:
    otherwise the token embedding dominates the residual stream and the
    tied output projection predicts the input token again (BOS forever)."""
    def f(path, a):
        keys = [k.key for k in path]
        if keys[0] == "decoder" and keys[-1] == "kernel" and keys[-2] in ("fc2", "out_proj"):
            return a * factor
        return a

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def env():
    """ofasys_tpu's target (2 layers) and draft (1 layer) with their init,
    perturbed, and the port's models with the same weights."""
    jd, td = _dict(JDictionary), _dict(Dictionary)
    toks = _tokens(jd, 2, 9, 0)
    jm, tm = {}, {}
    params = {}
    for name, layers, key in (("target", 2, 0), ("draft", 1, 7)):
        j = JModel(arch="tiny")
        j.cfg.encoder.layers = j.cfg.decoder.layers = layers
        j.cfg.dropout = 0.0
        j.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
        params[name] = _louder_decoder(_perturb(
            j.init_params(jax.random.PRNGKey(key), _jsample(toks)["net_input"]["slots"]), seed=key + 1))
        t = GeneralistModel(arch="tiny")
        t.cfg.encoder.layers = t.cfg.decoder.layers = layers
        t.cfg.dropout = 0.0
        t.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
        load_jax_params(t.net, params[name])
        jm[name], tm[name] = j, t
    env = dict(jd=jd, td=td, jm=jm, tm=tm, params=params)
    for seed in range(100):
        toks = _tokens(jd, 4, 9, seed)
        lens = [len(o[0].tokens) for o in _greedy(env, toks)]
        if min(lens) < MAX_LEN_B + 1 == max(lens):
            env["toks"] = toks
            break
    return env


def _jax_run(env, toks, gamma, draft="draft", **kw):
    gen = JSpeculative(env["jm"]["target"], env["jm"][draft], env["jd"], gamma=gamma,
                       max_len_b=MAX_LEN_B, **kw)
    out = gen.generate(env["params"]["target"], env["params"][draft], _jsample(toks))
    return out, gen.last_stats


def _port_run(env, toks, gamma, draft="draft", **kw):
    gen = SpeculativeGenerator(env["tm"]["target"], env["tm"][draft], env["td"], gamma=gamma,
                               max_len_b=MAX_LEN_B, **kw)
    gen.rejections = []
    return gen.generate(_tsample(toks)), gen


def _greedy(env, toks, **kw):
    gen = SequenceGenerator(env["tm"]["target"], env["td"], beam_size=1, max_len_b=MAX_LEN_B, **kw)
    return gen.generate(_tsample(toks))


@torch.no_grad()
def _argmax_decode(env, toks, min_len=1, constraint=None):
    """The target's greedy decode, one single-token step at a time: each
    row's tokens up to and including its first EOS."""
    net, d = env["tm"]["target"].net, env["td"]
    slots = _tsample(toks)["net_input"]["slots"]
    src = [dataclasses.replace(slots[0], value={"inputs": torch.as_tensor(toks.astype(np.int64))})]
    B, T_buf = toks.shape[0], MAX_LEN_B + 2
    dummy = dataclasses.replace(slots[1], value={"inputs": torch.zeros((B, T_buf), dtype=torch.long)})
    enc = net.encode(src)
    bias, cb, cache = net.decode_prepare([dummy], enc, T_buf)
    seq = [torch.full((B,), d.bos(), dtype=torch.long)]
    for step in range(MAX_LEN_B + 1):
        out, _, cache = net.decode_step(seq[-1][:, None], step, enc, bias, cb, cache, slots[1])
        lp = search.apply_min_len(torch.log_softmax(out[:, -1].float(), dim=-1), step, min_len, d.eos())
        if constraint is not None:
            lp = search.apply_constraint_range(lp, *constraint, d.eos())
        if step == MAX_LEN_B:
            lp = torch.full_like(lp, search.NEG_INF)
            lp[:, d.eos()] = 0.0
        seq.append(lp.argmax(dim=-1))
    rows = torch.stack(seq[1:], dim=1).numpy()
    return [r[: int(np.nonzero(r == d.eos())[0][0]) + 1] for r in rows]


def _exact(env, toks, tout, **kw):
    """tout is the target's greedy decode; beam 1 agrees, or parts from it
    where one of them takes EOS and scores better."""
    constraint = kw.pop("constraint", None)
    want = _argmax_decode(env, toks, constraint=constraint, **kw)
    if constraint is not None:
        kw["constraint_range"] = f"{constraint[0]},{constraint[1]}"
    for w, b, beam in zip(want, tout, _greedy(env, toks, **kw)):
        np.testing.assert_array_equal(b[0].tokens, w)
        bt, eos = beam[0].tokens, env["td"].eos()
        if not np.array_equal(bt, w):
            part = int(np.nonzero(bt[:min(len(bt), len(w))] != w[:min(len(bt), len(w))])[0][0])
            assert eos in (bt[part], w[part]) and bt[-1] == eos
            assert beam[0].score >= b[0].score


def _assert_same(jout, tout):
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a[0].tokens), b[0].tokens)
        np.testing.assert_allclose(b[0].score, a[0].score, rtol=SCORE_RTOL)


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_speculative_matches_ofasys_tpu_and_greedy(env, gamma):
    toks = env["toks"]
    jout, jstats = _jax_run(env, toks, gamma, min_len=2)
    tout, gen = _port_run(env, toks, gamma, min_len=2)
    _assert_same(jout, tout)
    assert gen.last_stats == jstats
    # one host read a verify, plus the prefill's and the readback
    assert gen.last_host_syncs == jstats["target_steps"] - 1 + 2
    _exact(env, toks, tout, min_len=2)
    eos = env["td"].eos()
    for b in tout:
        assert b[0].tokens[-1] == eos and (b[0].tokens[:-1] != eos).all()
    # the early row: tokens written past its EOS in lockstep were dropped
    assert min(len(o[0].tokens) for o in tout) < MAX_LEN_B + 1 == max(len(o[0].tokens) for o in tout)
    # a 1-layer draft of other weights: some proposals are rejected
    assert len(gen.rejections) > 0 and jstats["mean_accepted"] < gamma


def test_self_draft_accepts_every_proposal(env):
    toks = _tokens(env["jd"], 1, 9, 3)
    jout, jstats = _jax_run(env, toks, 4, draft="target")
    tout, gen = _port_run(env, toks, 4, draft="target")
    _assert_same(jout, tout)
    assert gen.last_stats == jstats
    assert gen.rejections == []
    loop = gen.last_stats["tokens"] - 1
    # every verify but the last accepts all 4 proposals
    assert gen.last_stats["target_steps"] - 1 == -(-loop // 5)
    _exact(env, toks, tout)


def test_constraint_range(env):
    """Only the range's tokens and EOS: the target's greedy decode under
    the same range."""
    toks = env["toks"]
    lo, hi = env["td"].nspecial + 10, env["td"].nspecial + 30
    tout, gen = _port_run(env, toks, 3, constraint_range=f"{lo},{hi}")
    eos = env["td"].eos()
    for b in tout:
        t = b[0].tokens
        assert (((t >= lo) & (t < hi)) | (t == eos)).all() and t[-1] == eos
    _exact(env, toks, tout, constraint=(lo, hi))


def test_verify_step_equals_single_steps(env):
    """decode_step with gamma + 1 tokens at cache offset 2 equals the same
    tokens fed one at a time (the relative-position bias rows step..step+4
    gathered by BiasSpec, the in-step causal mask)."""
    net = env["tm"]["target"].net
    toks = torch.as_tensor(_tokens(env["jd"], 2, 9, 5).astype(np.int64))
    slots = _tsample(toks.numpy())["net_input"]["slots"]
    tgt = slots[1]
    src = [dataclasses.replace(slots[0], value={"inputs": toks})]
    steps = torch.as_tensor(_tokens(env["jd"], 2, 7, 6).astype(np.int64))
    T_buf = 10
    dummy = dataclasses.replace(tgt, value={"inputs": torch.zeros((2, T_buf), dtype=torch.long)})
    with torch.no_grad():
        enc = net.encode(src)
        runs = []
        for chunks in ([1, 1, 5], [1] * 7):
            bias, cb, cache = net.decode_prepare([dummy], enc, T_buf)
            outs, pos = [], 0
            for n in chunks:
                out, _, cache = net.decode_step(steps[:, pos:pos + n], pos, enc, bias, cb, cache, tgt)
                outs.append(out)
                pos += n
            runs.append(torch.cat(outs, dim=1))
    np.testing.assert_allclose(runs[0].numpy(), runs[1].numpy(), rtol=STEP_TOL, atol=STEP_TOL)


# ------------------------------------------------------------------ the hub
@pytest.fixture(scope="module")
def hubs():
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text"])
    models = []
    for layers, seed in ((2, 0), (1, 1)):
        m = GeneralistModel(arch="tiny")
        m.cfg.encoder.layers = m.cfg.decoder.layers = layers
        m.initialize(d, dtype=torch.float32, device="cpu", seed=seed)
        models.append(m)
    return d, gp, models


def test_set_draft_routes_greedy_calls_only(hubs):
    d, gp, (target, draft) = hubs
    hub = OFASys(target, None, d, gp, device="cpu")
    data = [{"src": "the storm moved north"}, {"src": "over the coast on monday and tuesday"}]
    greedy = dict(beam_size=1, no_repeat_ngram_size=0, max_len_b=8)
    plain_greedy = hub.inference(TPL, data, **greedy)
    plain_beam = hub.inference(TPL, data, max_len_b=8)
    assert hub.set_draft(OFASys(draft, None, d, gp, device="cpu"), gamma=3) is hub
    spec_greedy = hub.inference(TPL, data, **greedy)
    spec_beam = hub.inference(TPL, data, max_len_b=8)
    kinds = {key[1]: type(g).__name__ for key, g in hub._generators.items()}
    assert kinds == {True: "SpeculativeGenerator", False: "SequenceGenerator"}
    for a, b in zip(plain_greedy + plain_beam, spec_greedy + spec_beam):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.text == b.text
    # int8 serving with the draft attached: the target is quantized, the
    # greedy calls still go through the speculative generator
    hub.quantize()
    q_spec = hub.inference(TPL, data, **greedy)
    hub._draft = None
    hub._generators.clear()
    q_plain = hub.inference(TPL, data, **greedy)
    for a, b in zip(q_plain, q_spec):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_set_draft_refuses_another_vocabulary(hubs):
    d, gp, (target, draft) = hubs
    hub = OFASys(target, None, d, gp, device="cpu")
    d2 = Dictionary()
    gp2 = GeneralPreprocess(d2, active=["text"])
    for i in range(8):
        d2.add_symbol(f"<x>_{i}")
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 1
    m.initialize(d2, dtype=torch.float32, device="cpu")
    other = OFASys(m, None, d2, gp2, device="cpu")
    assert len(d2) != len(d)
    with pytest.raises(ValueError, match="draft vocabulary differs"):
        hub.set_draft(other)
