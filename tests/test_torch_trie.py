"""The closed-set trie: ofasys_torch/utils/trie.py, the text preprocessor's
``ans2label_file`` and constraint masks, the compiled trie tables of
generator/search.py and trie-constrained beam search, against ofasys_tpu.

The answer table is written by the test (a ``.json`` answer -> label map
and the one-answer-a-line form) from a seeded vocabulary. Masks, tables and
per-step masks and transitions must be equal bit for bit; constrained
generation on the tiny fp32 model of tests/test_torch_search.py gives
ofasys_tpu's tokens (scores rtol 1e-5, top-k margins above 1e-4 in the JAX
run), and every answer is one of the table's (the length limit, 24 tokens,
is above the longest answer's: EOS forced at the limit would cut one).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.generator import search as jsearch
from ofasys_tpu.utils.trie import Trie as JTrie
from ofasys_torch import OFASys
from ofasys_torch.generator import search
from ofasys_torch.utils.trie import Trie

from test_torch_search import (  # noqa: F401  (fixture)
    MARGIN, SRCS, _one_torch_thread, assert_same_hypotheses, make_env, recording_top_k, samples,
)

WORDS = ["red", "blue", "two", "yes", "no", "cat", "on", "table", "a", "dog", "three", "green"]
CLOSED_TPL = "[TEXT:src] -> [TEXT:tgt,closed_set]"


def _answers(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        a = " ".join(rng.choice(WORDS, int(rng.integers(1, 4))))
        if a not in out:
            out.append(a)
    return out


@pytest.fixture(scope="module", params=["json", "lines"])
def trie_env(request, tmp_path_factory):
    answers = _answers()
    path = tmp_path_factory.mktemp("ans") / ("ans2label.json" if request.param == "json" else "ans2label.txt")
    if request.param == "json":
        path.write_text(json.dumps({a: i for i, a in enumerate(answers)}))
    else:
        path.write_text("\n".join(answers) + "\n")

    def setup(jtext, ttext):
        jtext._load_ans2label(str(path))
        ttext._load_ans2label(str(path))

    env = make_env(text_setup=setup)
    env["answers"] = answers
    return env


def test_trie_matches():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 9, int(rng.integers(1, 5))).tolist() for _ in range(30)]
    jt, tt = JTrie(eos=2), Trie(eos=2)
    for s in seqs:
        jt.insert(s)
        tt.insert(s)
    assert tt.root == jt.root
    for s in seqs + [[], [9], [1, 1, 1, 1, 1]]:
        for i in range(len(s) + 1):
            assert tt.get_next_layer(s[:i]) == jt.get_next_layer(s[:i])
            assert (s[:i] in tt) == (s[:i] in jt)


def test_ans2label_trie_and_masks_match(trie_env):
    env = trie_env
    jtext, ttext = env["jgp"].name2pre["text"], env["tgp"].name2pre["text"]
    assert ttext.ans2label == jtext.ans2label
    assert ttext.constraint_trie.root == jtext.constraint_trie.root
    recs = [{"src": s, "tgt": t} for s, t in zip(SRCS, env["answers"][:3] + ["not an answer"])]
    for split in ("train", "test"):
        js, ts = samples(env, recs, CLOSED_TPL, split)
        np.testing.assert_array_equal(ts["constraint_masks"], js["constraint_masks"])
        assert ts["constraint_masks"].dtype == np.bool_
        np.testing.assert_array_equal(ts["target"], js["target"])
    # an answer's masks allow its own next token at every position
    cm, tgt = ts["constraint_masks"], ts["target"]
    for b in range(3):
        for t in range(tgt.shape[1]):
            if tgt[b, t] != env["td"].pad():
                assert cm[b, t, tgt[b, t]]


@pytest.mark.parametrize("threshold", [64, 3])
def test_compiled_trie_matches(trie_env, threshold):
    env = trie_env
    trie = env["tgp"].name2pre["text"].constraint_trie
    V, bos = len(env["td"]), env["td"].bos()
    jt = jsearch.compile_trie(env["jgp"].name2pre["text"].constraint_trie, V, bos, threshold)
    tt = search.compile_trie(trie, V, bos, threshold)
    for name in ("tok", "nxt", "dense_idx", "dense_allowed", "dense_next"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    assert tt.initial_state == int(jt.initial_state) and tt.num_states == jt.num_states
    rng = np.random.default_rng(threshold)
    states = rng.integers(0, tt.num_states + 1, 64)
    allowed = np.asarray(jt.tok)[states]
    tokens = np.where(rng.random(64) < 0.7, np.take_along_axis(
        allowed, rng.integers(0, allowed.shape[1], 64)[:, None], 1)[:, 0], rng.integers(0, V, 64))
    tokens = np.where(tokens < 0, 5, tokens)
    np.testing.assert_array_equal(
        search.trie_allowed_mask(tt, torch.tensor(states), V).numpy(),
        np.asarray(jsearch.trie_allowed_mask(jt, jnp.asarray(states, jnp.int32), V)))
    np.testing.assert_array_equal(
        search.trie_advance(tt, torch.tensor(states), torch.tensor(tokens)).numpy(),
        np.asarray(jsearch.trie_advance(jt, jnp.asarray(states, jnp.int32), jnp.asarray(tokens, jnp.int32))))


@pytest.mark.parametrize("opts", [dict(beam_size=5, max_len_b=24), dict(beam_size=1, max_len_b=24),
                                  dict(beam_size=3, max_len_b=24, return_n_best=3)],
                         ids=["beam5", "greedy", "beam3_nbest"])
def test_trie_constrained_generation_matches_jax(trie_env, monkeypatch, opts):
    env = trie_env
    recs = [{"src": s} for s in SRCS]
    margins = []
    monkeypatch.setattr("jax.lax.top_k", recording_top_k(margins))
    jhub = JOFASys(env["jm"], env["params"][0], env["jd"], env["jgp"])
    jout = jhub.inference(CLOSED_TPL, recs, constraint_trie=env["jgp"].name2pre["text"].constraint_trie,
                          **opts)
    monkeypatch.undo()
    assert margins and min(margins) > MARGIN, min(margins, default=None)
    hub = OFASys(env["tms"][0], None, env["td"], env["tgp"], device="cpu")
    tout = hub.inference(CLOSED_TPL, recs, constraint_trie=env["tgp"].name2pre["text"].constraint_trie,
                         **opts)
    jl, tl = ([o if isinstance(o, list) else [o] for o in out] for out in (jout, tout))
    assert_same_hypotheses(jl, tl)
    answers = set(env["answers"])
    for hyps in tl:
        for h in hyps:
            assert h.text in answers, h.text
