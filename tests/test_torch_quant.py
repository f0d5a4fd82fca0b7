"""Int8 serving of ofasys_torch against ofasys_tpu: weight and row
quantization, the plain version of kernel B7 against the Pallas kernel (in
interpret mode) and the XLA int8 matmul, ``quantize_for_serving``, serving
variables carried across with ``load_jax_params`` and back with
``export_params``, and hub tokens after ``quantize()``.

Tiny arch, 2+2 layers, fp32 on both sides. Tolerances:
  * int8 values and scales: equal (the same fp32 division and round half
    to even on both sides);
  * B7's plain version against ``fused_w8a8_matmul`` and ``int8_matmul``:
    rtol and atol 2e-5 in fp32, as tests/test_quant.py holds the two JAX
    paths (the integer product is exact, the epilogue the same two fp32
    products);
  * one int8 encoder and decoder layer on the same inputs: each row
    quantization's sx within SX_RTOL and its xq equal but where x / sx lies
    within HALF_STEP_TOL of a .5 boundary; then JAX's xq and sx on both
    sides, and the outputs within atol 1e-4, the fp32 noise of the plain
    ops around the exact int8 products;
  * logits of the whole quantized model: 'w8' relative Frobenius error
    1e-3 and max abs W8_ATOL: the tied logits projection is w8a8 in both
    modes (``QuantEmbed.attend``), and one of its rows may take the other
    int8 step, moving that row by up to sx * scale * 127 (1.1e-2
    measured); 'w8a8' relative
    Frobenius error W8A8_REL and max abs W8A8_ATOL. In w8a8 an activation
    that differs by fp32 rounding can cross a .5 boundary of x / sx and move
    one int8 step, which moves the next projection by up to
    sx * scale * 127 (about 1e-2 here); that row then crosses more
    boundaries at the next projection, and attention spreads it to other
    rows: with 2+2 layers the int8 inputs of the last projections differ
    in a few percent of their entries (measured), the logits by up to 0.2;
  * tokens after ``quantize()``: identical, for beam and greedy search, in
    both modes, and the hypothesis scores within SCORE_ATOL.
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, OFASys as JOFASys
from ofasys_tpu.ops import quant as jquant
from ofasys_tpu.ops.pallas_int8 import fused_w8a8_matmul
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys
from ofasys_torch.ops import quant as tquant
from ofasys_torch.ops.int8_matmul import int8_matmul_fwd, int8_matmul_reference
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import slots_to_device

TPL = "[TEXT:src] -> [TEXT:tgt]"
SRCS = ["hello world", "the quick brown fox jumps", "over the lazy dog", "0123456789 abc", "a"]
TGTS = ["a greeting", "a fox", "a dog", "digits", "b"]
W8_ATOL = 2e-2
SX_RTOL = 1e-5         # a row scale from fp32 activations summed in another order
HALF_STEP_TOL = 1e-4   # x / sx that close to a .5 boundary may round either way
W8A8_REL, W8A8_ATOL = 5e-2, 0.3
SCORE_ATOL = 2e-2
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (``dtype`` a key
    of DTYPES)."""
    a = (rng.standard_normal(shape) * 0.7).astype(np.float32)
    j = jnp.asarray(a).astype(DTYPES[dtype][1])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][2])


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_weight_matches_jax(dtype):
    rng = np.random.default_rng(0)
    wj, wt = _arrays(rng, (96, 128), dtype)             # (in, out) as flax keeps it
    wj = wj.at[:, 5].set(0.0)                           # an all-zero channel: scale eps/127
    wt[:, 5] = 0.0
    qj, sj = jquant.quantize_weight(wj, axis=-2)
    qt, st = tquant.quantize_weight(wt.t(), axis=-1)    # (out, in) as the port keeps it
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.t().numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert int(qt.abs().max()) == 127


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_rows_matches_jax(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _arrays(rng, (3, 7, 128), dtype)
    qj, sj = jquant._quantize_rows(xj)
    qt, st = tquant._quantize_rows(xt)
    assert tuple(st.shape) == (3, 7, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("M", [256, 300], ids=["aligned", "ragged_rows"])
def test_int8_plain_version_matches_pallas_and_xla(M):
    """B7's plain version against ``fused_w8a8_matmul`` in interpret mode
    (N a multiple of 128: the Pallas kernel picks a block that divides N)
    and the XLA int8 matmul, fp32 out; and in bf16 out against the latter."""
    rng = np.random.default_rng(2)
    K, N = 128, 256
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32))
    q, scale = jquant.quantize_weight(w)
    xq, sx = jquant._quantize_rows(x)
    pallas = fused_w8a8_matmul(xq, sx, q, scale, out_dtype=jnp.float32, block_m=128, block_n=128)
    xla = jquant.int8_matmul(x, q, scale, mode="w8a8", out_dtype=jnp.float32)
    targs = (torch.from_numpy(np.asarray(xq)), torch.from_numpy(np.asarray(sx)),
             torch.from_numpy(np.asarray(q).T.copy()), torch.from_numpy(np.asarray(scale)))
    got = int8_matmul_reference(*targs, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=2e-5, atol=2e-5)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(int8_matmul_fwd(*targs, torch.float32), got)
    xla16 = jquant.int8_matmul(x, q, scale, mode="w8a8", out_dtype=jnp.bfloat16)
    got16 = int8_matmul_fwd(*targs, torch.bfloat16)
    np.testing.assert_array_equal(got16.float().numpy(), np.asarray(xla16.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_matmul_modes_match_jax(mode, dtype):
    rng = np.random.default_rng(3)
    xj, xt = _arrays(rng, (2, 9, 64), dtype)
    wj, wt = _arrays(rng, (64, 128), "fp32")
    qj, sj = jquant.quantize_weight(wj)
    qt, st = tquant.quantize_weight(wt.t())
    out_j = jquant.int8_matmul(xj, qj, sj, mode=mode, out_dtype=DTYPES[dtype][1])
    out_t = tquant.int8_matmul(xt, qt, st, mode=mode, out_dtype=DTYPES[dtype][2])
    assert out_t.shape == (2, 9, 128) and out_t.dtype == DTYPES[dtype][2]
    tol = 2e-5 if dtype == "fp32" else 1e-2                 # bf16: one ulp at |y| ~ 2
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_unknown_quant_mode_raises_as_in_jax():
    with pytest.raises(ValueError, match="quant mode"):
        jquant.int8_matmul(jnp.ones((2, 4)), jnp.ones((4, 3), jnp.int8), jnp.ones(3), mode="w4")
    with pytest.raises(ValueError, match="quant mode"):
        tquant.int8_matmul(torch.ones(2, 4), torch.ones(3, 4, dtype=torch.int8), torch.ones(3),
                           mode="w4")


# ------------------------------------------------------------------- models
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


def _torch_model(td):
    tm = GeneralistModel(arch="tiny")
    tm.cfg.encoder.layers = tm.cfg.decoder.layers = 2
    tm.cfg.dropout = 0.0
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    return tm, tgp


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
    jhub = JOFASys(jm, params, jd, jgp).quantize()
    variables = jax.device_get(jhub.params)

    td = _dictionary(Dictionary)
    tm, tgp = _torch_model(td)
    hub = OFASys(tm, variables, td, tgp, device="cpu")
    return {"jm": jm, "jhub": jhub, "jgp": jgp, "params": params, "variables": variables,
            "hub": hub}


def test_quantize_for_serving_prunes_and_keeps():
    td = _dictionary(Dictionary)
    tm, _ = _torch_model(td)
    net = tm.net
    before = dict(net.named_parameters())
    emb = net.embed_tokens.weight.detach().clone()
    with pytest.raises(ValueError, match="matched no Dense"):
        tquant.quantize_for_serving(copy.deepcopy(net), pattern=r"no_such_module\.weight$")
    assert tquant.quantize_for_serving(net) is net
    after = dict(net.named_parameters())
    pruned = sorted(set(before) - set(after))
    # every q/k/v/out projection and FFN matmul of both stacks: 2 + 2 layers
    expected = 2 * 6 + 2 * 10
    assert len(pruned) == expected and all(n.endswith(".weight") for n in pruned)
    assert all(n.rsplit(".", 2)[-2] in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
               for n in pruned)
    for n in pruned:
        mod = net.get_submodule(n.rsplit(".", 1)[0])
        assert mod.q.dtype == torch.int8 and tuple(mod.q.shape) == tuple(before[n].shape)
        assert mod.scale.dtype == torch.float32 and mod.bias is after[n[:-6] + "bias"]
    # the position projections, LayerNorms and the embedding keep their fp32 values
    assert "encoder_adaptor.pos_q_linear.weight" in after
    assert torch.equal(net.embed_tokens.weight, emb)
    assert tuple(net.embed_tokens.q.shape) == tuple(emb.shape)
    buffers = dict(net.named_buffers())
    assert "embed_tokens.q" in buffers and "decoder.layers_1.ffn.fc2.q" in buffers


def test_serving_variables_carried_across(env):
    """The JAX serving variables load into the port's int8 buffers, and
    export_params gives them back unchanged (a round trip)."""
    v, net = env["variables"], env["hub"].model.net
    np.testing.assert_array_equal(net.encoder.layers_0.self_attn.q_proj.q.numpy(),
                                  np.asarray(v["qkern"]["encoder"]["layers_0"]["self_attn"]["q_proj"]["q"]).T)
    np.testing.assert_array_equal(net.embed_tokens.q.numpy(),
                                  np.asarray(v["qkern"]["embed_tokens"]["q"]).T)
    out = export_params(net)
    assert set(out) == {"params", "qkern"}
    for coll in ("params", "qkern"):
        ja = dict(jax.tree_util.tree_leaves_with_path(v[coll]))
        ta = dict(jax.tree_util.tree_leaves_with_path(out[coll]))
        assert set(ja) == set(ta), coll
        for path, a in ja.items():
            np.testing.assert_array_equal(ta[path], np.asarray(a), err_msg=jax.tree_util.keystr(path))
    # ... and load again into a fresh net, unquantized before the load
    tm2, _ = _torch_model(_dictionary(Dictionary))
    load_jax_params(tm2.net, out)
    for (n1, b1), (n2, b2) in zip(net.named_buffers(), tm2.net.named_buffers(), strict=True):
        assert n1 == n2 and torch.equal(b1, b2)
    for (n1, p1), (n2, p2) in zip(net.named_parameters(), tm2.net.named_parameters(), strict=True):
        assert n1 == n2 and torch.equal(p1, p2)


def test_port_quantize_equals_jax_quantize(env):
    """hub.quantize() on the port from the fp32 parameters makes the same
    int8 tables and scales as ofasys_tpu's quantize_for_serving."""
    td = _dictionary(Dictionary)
    tm, tgp = _torch_model(td)
    hub = OFASys(tm, env["params"], td, tgp, device="cpu")
    assert hub.quantize() is hub and tm.cfg.quant_mode == "w8a8"
    n_buffers = len(list(tm.net.buffers()))
    hub.quantize("w8")                              # idempotent: only the mode changes
    assert tm.cfg.quant_mode == "w8" and len(list(tm.net.buffers())) == n_buffers
    out = export_params(tm.net)
    for coll in ("params", "qkern"):
        ja = dict(jax.tree_util.tree_leaves_with_path(env["variables"][coll]))
        ta = dict(jax.tree_util.tree_leaves_with_path(out[coll]))
        assert set(ja) == set(ta)
        for path, a in ja.items():
            np.testing.assert_array_equal(ta[path], np.asarray(a), err_msg=jax.tree_util.keystr(path))


def test_quantized_layers_match_jax(env):
    """One int8 encoder layer and one int8 decoder layer of the carried
    variables on the same inputs, with the same int8 activations on both
    sides. Each of the port's row quantizations is held to JAX's at the
    same call: sx within SX_RTOL, xq equal but where the port's x / sx lies
    within HALF_STEP_TOL of a .5 boundary, and there one step away (the fp32
    noise of the ops before it decides the rounding; module docstring). The
    port then goes on with JAX's xq and sx, so such a flip cannot cascade
    through the later projections, and the outputs are held at atol 1e-4."""
    from ofasys_tpu.model.transformer import TransformerDecoderLayer as JDec
    from ofasys_tpu.model.transformer import TransformerEncoderLayer as JEnc

    jm, v, net = env["jm"], env["variables"], env["hub"].model.net
    env["jhub"].quantize("w8a8")
    env["hub"].quantize("w8a8")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 256)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 256)).astype(np.float32)
    keep = np.ones((2, 1, 1, 12), bool)
    keep[1, ..., 10:] = False

    def variables(stack):
        return {c: v[c][stack]["layers_0"] for c in ("params", "qkern")}

    jcalls = []
    real_j, real_t = jquant._quantize_rows, tquant._quantize_rows

    def record(a):
        xq, sx = real_j(a)
        jcalls.append((np.array(xq), np.array(sx, np.float32)))
        return xq, sx

    def pinned(a):
        xq, sx = real_t(a)
        jxq, jsx = (torch.from_numpy(t).reshape(u.shape)
                    for t, u in zip(jcalls[pinned.calls], (xq, sx)))
        pinned.calls += 1
        np.testing.assert_allclose(sx.numpy(), jsx.numpy(), rtol=SX_RTOL, atol=0)
        flip = xq != jxq
        r = (a.float() / sx)[flip].abs()
        assert ((r - r.floor() - 0.5).abs() <= HALF_STEP_TOL).all(), r
        assert ((xq.int() - jxq.int())[flip].abs() == 1).all()
        return jxq, jsx

    pinned.calls = 0
    with mock.patch.object(jquant, "_quantize_rows", record):
        jo = JEnc(jm.cfg, dtype=jnp.float32).apply(variables("encoder"), jnp.asarray(x),
                                                   jnp.asarray(keep))
        jd, _ = JDec(jm.cfg, dtype=jnp.float32).apply(variables("decoder"), jnp.asarray(x),
                                                      jnp.asarray(enc))
    with mock.patch.object(tquant, "_quantize_rows", pinned), torch.no_grad():
        to = net.encoder.layers_0(torch.from_numpy(x), torch.from_numpy(keep))
        td, _ = net.decoder.layers_0(torch.from_numpy(x), torch.from_numpy(enc))
    assert pinned.calls == len(jcalls) > 0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_quantized_logits_match_jax(env, mode):
    jm, jgp, hub = env["jm"], env["jgp"], env["hub"]
    recs = [{"src": s, "tgt": t} for s, t in zip(SRCS, TGTS)]
    js = jgp.collate([jgp(JInstruction(TPL, split="train").format(**r)) for r in recs])
    tgp = hub.general_preprocess
    ts = tgp.collate([tgp(Instruction(TPL, split="train").format(**r)) for r in recs])
    env["jhub"].quantize(mode)
    hub.quantize(mode)
    jl, _ = jm.apply(env["variables"], js["net_input"]["slots"])
    with torch.no_grad():
        tl, _ = hub.model.net(slots_to_device(ts["net_input"]["slots"], "cpu"))
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    rel, mx = np.linalg.norm(tl - jl) / np.linalg.norm(jl), np.abs(tl - jl).max()
    lim_rel, lim_max = (1e-3, W8_ATOL) if mode == "w8" else (W8A8_REL, W8A8_ATOL)
    assert rel <= lim_rel and mx <= lim_max, (rel, mx)


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
@pytest.mark.parametrize("opts", [{"beam_size": 1, "max_len_b": 10},
                                  {"beam_size": 2, "max_len_b": 10}], ids=["greedy", "beam2"])
def test_quantized_hub_tokens_match_jax(env, mode, opts):
    recs = [{"src": s} for s in SRCS]
    jout = env["jhub"].quantize(mode).inference(TPL, recs, **opts)
    tout = env["hub"].quantize(mode).inference(TPL, recs, **opts)
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert a.text == b.text
        assert abs(a.score - b.score) <= SCORE_ATOL
