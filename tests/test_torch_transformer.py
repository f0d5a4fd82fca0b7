"""ofasys_torch's transformer stacks and GeneralistNet against ofasys_tpu's.

Tiny arch with 2 encoder and 2 decoder layers, fp32 on both sides. The JAX
model's parameters (perturbed from init so every table and bias matters)
are carried into the port with ``load_jax_params``; inputs come from a
numpy seed. Tolerance: atol 1e-4 (fp32 through a few layers, sums taken in
another order).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.model import transformer as jtr
from ofasys_tpu.ops import pallas_dense_attention as jdense
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.model import transformer as ttr
from ofasys_torch.ops import dense_attention as tdense
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import load_jax_params
from ofasys_torch.utils.pytree import slots_to_device

TPL = "[TEXT:src] -> [TEXT:tgt]"
ATOL = 1e-4
BIAS_ATOL = 2e-5     # a few fp32 ulps of an attention bias of |bias| <= 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(params, seed=0):
    """Random values for tables and biases, larger kernels: outputs then
    depend on every parameter and on the input."""
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
def models():
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
    load_jax_params(tm.net, params)
    return jm, params, jgp, tm, tgp


def _batch(jgp, tgp, srcs):
    js = jgp.collate([jgp(JInstruction(TPL, split="test").format(src=s)) for s in srcs])
    ts = tgp.collate([tgp(Instruction(TPL, split="test").format(src=s)) for s in srcs])
    return js["net_input"]["slots"], slots_to_device(ts["net_input"]["slots"], "cpu")


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), rtol=0, atol=atol)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _jax_mha(cfg, E, H, attn_kernel=None):
    return jtr.MultiheadAttention(
        E, H, scale_factor=cfg.attn_scale_factor, scale_heads=cfg.scale_heads,
        dtype=jnp.float32, logits_compute=cfg.attn_logits == "compute", fuse_qkv=cfg.fuse_qkv,
        attn_layout=cfg.attn_layout, attn_kernel=attn_kernel or cfg.attn_kernel,
    )


# ------------------------------------------------------------------- params
def test_load_jax_params_fills_every_parameter(models):
    jm, params, _, tm, _ = models
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(list(tm.net.parameters()))
    w = tm.net.encoder.layers_0.self_attn.q_proj.weight.detach().numpy()
    np.testing.assert_array_equal(w, params["encoder"]["layers_0"]["self_attn"]["q_proj"]["kernel"].T)
    np.testing.assert_array_equal(tm.net.encoder.layer_norm.weight.detach().numpy(),
                                  params["encoder"]["layer_norm"]["scale"])


@pytest.mark.parametrize("fault", ["unused", "missing", "shape"])
def test_load_jax_params_raises(models, fault):
    _, params, _, tm, _ = models
    bad = jax.tree.map(lambda a: a, params)
    if fault == "unused":
        bad["encoder"]["layers_0"]["self_attn"]["extra"] = np.zeros(3, np.float32)
    elif fault == "missing":
        del bad["encoder"]["layer_norm"]
    else:
        bad["encoder"]["layer_norm"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load_jax_params(tm.net, bad)


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("kind", ["self", "self_causal", "cross", "cached_step"])
def test_multihead_attention(models, kind):
    jm, params, _, tm, _ = models
    cfg = jm.cfg
    E, H = cfg.encoder.embed_dim, cfg.encoder.attention_heads
    D = E // H
    rng = np.random.default_rng(1)
    B, Tq, Tk = 2, 8, 12
    if kind == "cross":
        p = params["decoder"]["layers_0"]["encoder_attn"]
        tmod = tm.net.decoder.layers_0.encoder_attn
    elif kind == "self":
        p = params["encoder"]["layers_1"]["self_attn"]
        tmod = tm.net.encoder.layers_1.self_attn
    else:
        p = params["decoder"]["layers_1"]["self_attn"]
        tmod = tm.net.decoder.layers_1.self_attn
    jmod = _jax_mha(cfg, E, H)
    x = _rand(rng, B, Tq, E)
    if kind == "cross":
        kv = _rand(rng, B, Tk, E)
        keep = rng.random((B, 1, 1, Tk)) > 0.3
        keep[..., 0] = True
        bias = _rand(rng, 1, H, Tq, Tk)
        jo, _ = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(kv), bias=jnp.asarray(bias),
                           mask=jnp.asarray(keep))
        to, _ = tmod(torch.from_numpy(x), torch.from_numpy(kv), bias=torch.from_numpy(bias),
                     mask=torch.from_numpy(keep))
        _close(to, jo)
    elif kind in ("self", "self_causal"):
        causal = kind == "self_causal"
        keep = rng.random((B, 1, 1, Tq)) > 0.3
        keep[..., 0] = True
        bias = _rand(rng, 1, H, Tq, Tq)
        jo, _ = jmod.apply({"params": p}, jnp.asarray(x), bias=jnp.asarray(bias),
                           mask=jnp.asarray(keep), causal=causal)
        to, _ = tmod(torch.from_numpy(x), bias=torch.from_numpy(bias), mask=torch.from_numpy(keep),
                     causal=causal)
        _close(to, jo)
    else:
        T_buf, idx = 10, 3
        ck, cv = _rand(rng, B, T_buf, H, D), _rand(rng, B, T_buf, H, D)
        step = x[:, :1]
        bias = _rand(rng, 1, H, 1, T_buf)
        jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "index": jnp.int32(idx)}
        jo, jc = jmod.apply({"params": p}, jnp.asarray(step), bias=jnp.asarray(bias), cache=jcache)
        tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()), "index": idx}
        to, tc = tmod(torch.from_numpy(step), bias=torch.from_numpy(bias), cache=tcache)
        _close(to, jo)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
        assert tc["index"] == int(jc["index"]) == idx + 1


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("kind", ["encoder", "decoder", "decoder_cached"])
def test_layers(models, kind):
    jm, params, _, tm, _ = models
    cfg = jm.cfg
    E, H = cfg.encoder.embed_dim, cfg.encoder.attention_heads
    D = E // H
    rng = np.random.default_rng(2)
    B, T, Ts = 2, 8, 12
    x = _rand(rng, B, T, E)
    keep = rng.random((B, 1, 1, T)) > 0.3
    keep[..., 0] = True
    bias = _rand(rng, 1, H, T, T)
    if kind == "encoder":
        jl = jtr.TransformerEncoderLayer(cfg, 0.0, dtype=jnp.float32)
        jo = jl.apply({"params": params["encoder"]["layers_0"]}, jnp.asarray(x), jnp.asarray(keep),
                      jnp.asarray(bias), True, None)
        to = tm.net.encoder.layers_0(torch.from_numpy(x), torch.from_numpy(keep), torch.from_numpy(bias))
        _close(to, jo)
        return
    enc = _rand(rng, B, Ts, E)
    ckeep = rng.random((B, 1, 1, Ts)) > 0.3
    ckeep[..., 0] = True
    cbias = _rand(rng, 1, H, T, Ts)
    jl = jtr.TransformerDecoderLayer(cfg, 0.0, dtype=jnp.float32)
    p = {"params": params["decoder"]["layers_1"]}
    tl = tm.net.decoder.layers_1
    if kind == "decoder":
        jo, _ = jl.apply(p, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(keep), jnp.asarray(bias),
                         jnp.asarray(ckeep), jnp.asarray(cbias), True, None, None, False)
        to, _ = tl(torch.from_numpy(x), torch.from_numpy(enc), torch.from_numpy(keep),
                   torch.from_numpy(bias), torch.from_numpy(ckeep), torch.from_numpy(cbias))
        _close(to, jo)
        return
    T_buf, idx = 10, 4
    ck, cv = _rand(rng, B, T_buf, H, D), _rand(rng, B, T_buf, H, D)
    xk, xv = _rand(rng, B, Ts, H, D), _rand(rng, B, Ts, H, D)
    sb, cb = bias[:, :, :1, :1].repeat(T_buf, axis=3), cbias[:, :, :1]
    jc = {"self": {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "index": jnp.int32(idx)},
          "cross": {"k": jnp.asarray(xk), "v": jnp.asarray(xv)}}
    jo, jnc = jl.apply(p, jnp.asarray(x[:, :1]), jnp.asarray(enc), None, jnp.asarray(sb),
                       jnp.asarray(ckeep), jnp.asarray(cb), True, jc, None, False)
    tc = {"self": {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()), "index": idx},
          "cross": {"k": torch.from_numpy(xk), "v": torch.from_numpy(xv)}}
    to, tnc = tl(torch.from_numpy(x[:, :1]), torch.from_numpy(enc), None, torch.from_numpy(sb),
                 torch.from_numpy(ckeep), torch.from_numpy(cb), tc)
    _close(to, jo)
    _close(tnc["self"]["k"], jnc["self"]["k"])


# ---------------------------------------------------------------------- net
SRCS = ["hello world", "the quick brown fox jumps", "over the lazy dog", "0123456789 abc"]


def test_encoder_and_forward_logits(models):
    jm, params, jgp, tm, tgp = models
    jslots, tslots = _batch(jgp, tgp, SRCS)
    jl, extra = jax.jit(lambda p, s: jm.net.apply({"params": p}, s))(params, jslots)
    jenc = extra["encoder_out"]
    with torch.no_grad():
        tl, textra = tm.net(tslots)
    tenc = textra["encoder_out"]
    _close(tenc.x, jenc.x)
    np.testing.assert_array_equal(tenc.padding_mask.numpy(), np.asarray(jenc.padding_mask))
    _close(tenc.pos_embed, jenc.pos_embed)
    _close(tl, jl)


def test_decode_step_logits(models):
    """decode_prepare + three decode steps with the KV cache."""
    jm, params, jgp, tm, tgp = models
    jslots, tslots = _batch(jgp, tgp, SRCS)
    T_buf = 8
    rng = np.random.default_rng(4)
    toks = rng.integers(4, 60, size=(len(SRCS), T_buf)).astype(np.int32)
    jnet, v = jm.net, {"params": params}
    jtgt = [s for s in jslots if not s.is_src][-1]
    ttgt = [s for s in tslots if not s.is_src][-1]
    jenc = jax.jit(lambda v, s: jnet.apply(v, s, method=jnet.encode))(v, [s for s in jslots if s.is_src])
    jdummy = dataclasses.replace(jtgt, value={"inputs": jnp.zeros((len(SRCS), T_buf), jnp.int32)})
    jspec, jcb, jcache = jnet.apply(v, [jdummy], jenc, T_buf, method=jnet.decode_prepare)
    jstep = jax.jit(lambda v, t, i, c: jnet.apply(v, t, i, jenc, jspec, jcb, c, jtgt,
                                                  method=jnet.decode_step))
    with torch.no_grad():
        tenc = tm.net.encode([s for s in tslots if s.is_src])
        tdummy = dataclasses.replace(ttgt, value={"inputs": torch.zeros((len(SRCS), T_buf), dtype=torch.long)})
        tspec, tcb, tcache = tm.net.decode_prepare([tdummy], tenc, T_buf)
        _close(tcb, jcb)
        _close(tspec.abs_bias, jspec.abs_bias)
        for step in range(3):
            jlog, _, jcache = jstep(v, jnp.asarray(toks[:, step:step + 1]), jnp.int32(step), jcache)
            tlog, _, tcache = tm.net.decode_step(torch.from_numpy(toks[:, step:step + 1]).long(), step,
                                                 tenc, tspec, tcb, tcache, ttgt)
            _close(tlog, jlog)


def test_dense_kernel_route_matches_pallas_interpret(models):
    """attn_kernel='pallas': JAX runs the Pallas kernel in interpret mode,
    the port runs kernel B1's plain version; B·T >= 256 opens the gate.

    Both kernels take the batch-shared bias rounded to bf16. The fp32 bias
    each side forms (the position and relative-position terms, summed in
    another order) differs by a few fp32 ulps (under 1e-5 at |bias| <= 16),
    and on some CPUs that flips a bf16 rounding of the bias: one bf16 ulp,
    up to 0.03 in a score, about 1e-2 in the encoder output. So each layer's
    fp32 bias is held to JAX's (BIAS_ATOL), and then the kernel takes JAX's
    bias on both sides: the encoder output is held at ATOL whatever the
    machine's summation order."""
    jm, params, jgp, tm, tgp = models
    srcs = [s * 6 for s in SRCS]                     # T = 72, B*T = 288
    jslots, tslots = _batch(jgp, tgp, srcs)
    assert tslots[0].value["inputs"].numel() >= 256
    jcfg = dataclasses.replace(jm.cfg, attn_kernel="pallas")
    jnet = jm.net.clone(cfg=jcfg)
    jbias = []
    real_jdense, real_tdense = jdense.dense_attention, ttr.dense_attention

    def record(q, k, v, *args, bias=None, **kw):
        jbias.append(np.array(bias, np.float32))
        return real_jdense(q, k, v, *args, bias=bias, **kw)

    def pinned(q, k, v, *, bias, **kw):
        jb = torch.from_numpy(jbias[pinned.calls]).reshape(bias.shape).to(bias.dtype)
        pinned.calls += 1
        np.testing.assert_allclose(bias.float().numpy(), jb.float().numpy(), rtol=0, atol=BIAS_ATOL)
        return real_tdense(q, k, v, bias=jb, **kw)

    pinned.calls = 0
    # op by op, as the port runs: the bias is rounded to bf16 before the
    # kernel, so a fused (jitted) fp32 bias sum could flip a bf16 rounding
    with mock.patch.object(jdense, "dense_attention", record):
        jenc = jnet.apply({"params": params}, [s for s in jslots if s.is_src], method=jnet.encode)
    tm.cfg.attn_kernel = "pallas"
    try:
        with mock.patch.object(tdense, "dense_attention_fwd_reference",
                               wraps=tdense.dense_attention_fwd_reference) as ref, \
                mock.patch.object(ttr, "dense_attention", pinned), torch.no_grad():
            tenc = tm.net.encode([s for s in tslots if s.is_src])
    finally:
        tm.cfg.attn_kernel = "auto"
    assert ref.call_count == tm.cfg.encoder.layers == len(jbias) == pinned.calls
    _close(tenc.x, jenc.x)


VARIANTS = {
    "post_ln_resids_relu": {"normalize_before": False, "scale_resids": True, "activation_fn": "relu"},
    "no_bias_no_scales": {"use_self_attn_bias": False, "scale_attn": False, "scale_fc": False,
                          "scale_heads": False, "fuse_qkv": False},
    "entangled_shared": {"entangle_position_embedding": True, "share_attn_bias": True,
                         "layernorm_embedding": False, "add_type_embedding": False,
                         "attn_logits": "fp32"},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variants_match(variant):
    """The model config's switches change the JAX and torch nets alike:
    whole-net logits on the same parameters, one layer per stack."""
    opts = dict(VARIANTS[variant])
    pre = opts.pop("normalize_before", True)

    def configure(m):
        m.cfg.encoder.layers = m.cfg.decoder.layers = 1
        m.cfg.encoder.normalize_before = m.cfg.decoder.normalize_before = pre
        m.cfg.dropout = 0.0
        for k, val in opts.items():
            setattr(m.cfg, k, val)

    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    configure(jm)
    jgp = JGeneralPreprocess(jd, active=["text"])
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    ist = jgp(JInstruction(TPL, split="test").format(src="a b"))
    params = _perturb(jm.init_params(jax.random.PRNGKey(1), jgp.collate([ist])["net_input"]["slots"]))
    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    configure(tm)
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    load_jax_params(tm.net, params)
    jslots, tslots = _batch(jgp, tgp, SRCS)
    jl, _ = jax.jit(lambda p, s: jm.net.apply({"params": p}, s))(params, jslots)
    with torch.no_grad():
        tl, _ = tm.net(tslots)
    _close(tl, jl)
