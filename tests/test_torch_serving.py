"""The text→text serving slice of ofasys_torch against ofasys_tpu:
preprocessing and collation, hub inference tokens (greedy and beam), and
the dynamic-batching server.

Tiny arch, 2+2 layers, fp32 on both sides, the same perturbed parameters
(carried with ``load_jax_params``). Token sequences must be identical;
scores agree to atol 1e-4. So that a near-tie cannot flip between
``lax.top_k`` and the port's selection, each JAX run records the margin at
every top-k boundary of its decode loop (k-th vs (k+1)-th candidate, where
the latter is a real score and not the -1e9 mask) and the test first
asserts that all of them exceed 1e-3.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, OFASys as JOFASys
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.serve import InferenceServer, serve_http

TPL = "[TEXT:src] -> [TEXT:tgt]"
TEMPLATES = [TPL, "[TEXT:src] what does it say? -> [TEXT:tgt]", "[TEXT:src] -> answer: [TEXT:tgt]"]
SRCS = ["hello world", "the quick brown fox jumps", "over the lazy dog", "0123456789 abc", "a"]
NEG_INF = -1e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(params, seed=1):
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


def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


@pytest.fixture(scope="module")
def env():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    jm.cfg.encoder.layers = jm.cfg.decoder.layers = 2
    jm.cfg.dropout = 0.0
    jgp = JGeneralPreprocess(jd, active=["text"])
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    ist = jgp(JInstruction(TPL, split="test").format(src="a b"))
    params = _perturb(jm.init_params(jax.random.PRNGKey(0), jgp.collate([ist])["net_input"]["slots"]))

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    tm.cfg.encoder.layers = tm.cfg.decoder.layers = 2
    tm.cfg.dropout = 0.0
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    hub = OFASys(tm, params, td, tgp, device="cpu")
    return {"jm": jm, "jd": jd, "jgp": jgp, "params": params, "hub": hub}


@pytest.mark.parametrize("template", TEMPLATES)
def test_preprocess_and_collate_match(env, template):
    jgp, hub = env["jgp"], env["hub"]
    recs = [{"src": s} for s in SRCS]
    js = jgp.collate([jgp(JInstruction(template, split="test").format(**r)) for r in recs])
    ts = hub.general_preprocess.collate(
        [hub.general_preprocess(Instruction(template, split="test").format(**r)) for r in recs])
    assert len(env["jd"]) == len(hub.global_dict)
    assert env["jd"].symbols == hub.global_dict.symbols
    assert set(js) == set(ts)
    for key in js:
        if key == "net_input":
            continue
        if isinstance(js[key], np.ndarray):
            np.testing.assert_array_equal(ts[key], js[key])
            assert ts[key].dtype == js[key].dtype
        else:
            assert ts[key] == js[key]
    for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
        assert (a.modality.name, a.is_src, a.column_name, a.attributes, a.split) == \
            (b.modality.name, b.is_src, b.column_name, b.attributes, b.split)
        np.testing.assert_array_equal(b.value["inputs"], a.value["inputs"])
        assert b.value["inputs"].dtype == a.value["inputs"].dtype


def _recording_top_k(margins):
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


GREEDY = {"beam_size": 1, "max_len_b": 10}
BEAM2 = {"beam_size": 2, "max_len_b": 10}


@pytest.mark.parametrize("template,opts", [
    (TEMPLATES[0], GREEDY),
    (TEMPLATES[2], GREEDY),
    (TEMPLATES[0], BEAM2),
    (TEMPLATES[2], BEAM2),
    (TEMPLATES[0], {"beam_size": 2, "max_len_b": 8, "lenpen": 0.5, "min_len": 3,
                    "no_repeat_ngram_size": 2}),
    (TEMPLATES[2], {"beam_size": 2, "max_len_b": 14, "max_len": 11, "temperature": 0.8,
                    "unkpen": 0.5, "normalize_scores": False, "return_n_best": 2}),
    (TEMPLATES[0], {"beam_size": 1, "match_source_len": True}),
], ids=["greedy", "greedy_prefix", "beam2", "beam2_prefix", "beam2_opts", "beam2_nbest_prefix",
        "greedy_srclen"])
def test_hub_tokens_match_jax(env, monkeypatch, template, opts):
    recs = [{"src": s} for s in SRCS]
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", _recording_top_k(margins))
    jhub = JOFASys(env["jm"], env["params"], env["jd"], env["jgp"])
    jout = jhub.inference(template, recs, **opts)
    monkeypatch.undo()
    assert margins and min(margins) > 1e-3, f"near-tie in the JAX run: {min(margins, default=None)}"
    tout = env["hub"].inference(template, recs, **opts)
    for ja, tb in zip(jout, tout, strict=True):
        ja, tb = (x if isinstance(x, list) else [x] for x in (ja, tb))
        for a, b in zip(ja, tb, strict=True):
            np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
            assert abs(a.score - b.score) <= 1e-4
            assert a.text == b.text


def test_hub_single_record_returns_one_result(env):
    out = env["hub"].inference(TPL, {"src": "hello world"}, beam_size=2, max_len_b=6)
    assert out.tokens.dtype == np.int32 and out.tokens[-1] == env["hub"].global_dict.eos()
    assert np.isfinite(out.score) and isinstance(out.text, str)


def test_server_batched_answers_match_direct(env):
    hub = env["hub"]
    datas = [{"src": f"word{i % 4} thing{i % 3}"} for i in range(10)]
    direct = [hub.inference(TPL, dd, beam_size=2, max_len_b=6) for dd in datas]
    srv = InferenceServer(hub, max_batch=8, max_wait_ms=200.0, device="cpu")
    futs = [srv.submit(TPL, dd, beam_size=2, max_len_b=6) for dd in datas]
    outs = [f.result(timeout=300) for f in futs]
    srv.close()
    for o, ref in zip(outs, direct):
        np.testing.assert_array_equal(o.tokens, ref.tokens)
        assert np.isfinite(o.score)
    st = srv.stats()
    assert st["requests"] == 10
    assert st["batches"] < 10
    assert st["mean_batch_occupancy"] > 1.0


def test_server_error_propagates_and_http(env):
    hub = env["hub"]
    srv = InferenceServer(hub, max_batch=2, max_wait_ms=1.0, device="cpu")
    fut = srv.submit(TPL, {"wrong_column": "x"}, beam_size=1, max_len_b=4)
    with pytest.raises(ValueError, match="missing value for source slot"):
        fut.result(timeout=120)
    httpd = serve_http(srv, host="127.0.0.1", port=0, block=False)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
        body = json.dumps({"instruction": TPL, "data": {"src": "hello there"},
                           "options": {"beam_size": 1, "max_len_b": 4}})
        conn.request("POST", "/v1/generate", body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert "text" in json.loads(resp.read())["output"]
    finally:
        httpd.shutdown()
        srv.close()


def test_vocab_growth_after_init_raises():
    d = Dictionary()
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 1
    m.initialize(d, active_adaptors=("text",), device="cpu")
    gp = GeneralPreprocess(d, active=["text"])  # the byte namespace grows d
    with pytest.raises(ValueError, match="initialized for a .*vocabulary"):
        OFASys(m, None, d, gp, device="cpu")


@pytest.mark.parametrize("opt", [{"sampling": True}, {"constraint_range": "4,8"},
                                 {"search_strategy": "diverse_beam"}])
def test_unported_generation_options_raise(env, opt):
    with pytest.raises(NotImplementedError):
        env["hub"].inference(TPL, {"src": "x"}, **opt)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_is_refused_until_ported(mode):
    """``remat`` (per-layer checkpointing in ofasys_tpu) changes memory, not
    values; the port has no counterpart yet, so a non-default value raises
    and names the item it waits for instead of being ignored."""
    m = GeneralistModel(arch="tiny", remat=mode)
    with pytest.raises(NotImplementedError, match=r"remat=.*Queue A item 13"):
        m.initialize(Dictionary(), active_adaptors=("text",), device="cpu")
