"""The long-text slice of ofasys_torch (text sources and targets past 256
tokens, which ofasys_tpu sends to its flash kernels) against ofasys_tpu.

Tiny arch, 2+2 layers (E=64, FFN 256, 4 heads), fp32 on both sides, the same
perturbed parameters (carried with ``load_jax_params``). The text
preprocessor's ``max_src_length`` and ``max_tgt_length`` are raised to 1,000
on both sides, as examples/long_context.yaml says; every sequence with bos
and eos then fits the 1,024 learned positions.

  * positions, rel-pos buckets and the cross-attention bias at T = 1,000:
    forward logits atol 1e-4 (fp32 through a few layers);
  * hub tokens, greedy and beam, on sources of 300-400 bytes: the port is
    routed through the flash kernels' plain versions (``flash_available``
    patched; on the card they are the kernels), and ofasys_tpu through its
    Pallas flash kernels in interpret mode (``_flash_available`` patched), so
    both round the bias to bf16 before the kernel. Tokens identical, scores
    atol 1e-4, after checking that every top-k margin of the JAX run
    exceeds 1e-3;
  * a default-length hub cuts a 300-byte source to 257 tokens, which the
    flash route takes;
  * one summed two-task update (text_infilling and gigaword templates,
    sources of 300-400 bytes) with the port on the flash plain versions
    (forward B3, backward B4 and B5) against ofasys_tpu on its XLA path.
    The flash route rounds the attention bias to bf16 and returns its
    gradient in bf16 (as ofasys_tpu's flash does); the XLA path keeps both
    in fp32. That rounding (relative 2^-9 per entry) moves the losses and
    gnorm within rtol 1e-3, and each gradient leaf within 1e-5 + 3e-2 of its
    largest entry: the position leaves (positions, pos_q/k_linear, the
    rel-pos tables) sum many bias-gradient entries that largely cancel and
    differ by up to 2.4e-2 of their largest entry, the other leaves by up to
    7.6e-3 (measured here). The key-side biases (``k_proj``,
    ``pos_k_linear``, ``cross_pos_k_linear``) add the same amount to every
    score of a softmax row: their gradient is 0 in exact arithmetic and the
    bf16 rounding of the bias gradient on the flash route leaves up to
    1e-3 of their kernel's largest gradient entry, so they are held to
    1e-5 + 3e-2 x 0.1 x that.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, OFASys as JOFASys
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.model import positional as jpos
from ofasys_tpu.model import transformer as jtr
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.model import positional as tpos
from ofasys_torch.model import transformer as ttr
from ofasys_torch.ops import flash_attention as tflash
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.text import TextPreprocessConfig
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device, slots_to_device

SUMMARY = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
LONG = 1000
NEG_INF = -1e9
SEED_BEAM = 14
LOSS_RTOL = 1e-3
GRAD_ATOL, GRAD_RTOL = 1e-5, 3e-2
KEY_BIAS_FRACTION = 0.1
# key-side biases: a shift of every score of a softmax row (module docstring)
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configure(cfg):
    for stack in (cfg.encoder, cfg.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    cfg.dropout = 0.0


def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


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


def _words(rng, n_chars):
    words = ["the", "storm", "moved", "north", "over", "the", "coast", "and", "officials", "said",
             "schools", "would", "stay", "closed", "for", "two", "days", "while", "crews", "work"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


@pytest.fixture(scope="module")
def env():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _configure(jm.cfg)
    jgp = JGeneralPreprocess(jd, active=["text"])
    jgp.name2pre["text"].cfg.max_src_length = jgp.name2pre["text"].cfg.max_tgt_length = LONG
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    ist = jgp(JInstruction(SUMMARY, split="test").format(src="a b"))
    params = _perturb(jm.init_params(jax.random.PRNGKey(0), jgp.collate([ist])["net_input"]["slots"]))

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _configure(tm.cfg)
    tgp = GeneralPreprocess(td, active=["text"],
                            text_cfg=TextPreprocessConfig(max_src_length=LONG, max_tgt_length=LONG))
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    hub = OFASys(tm, params, td, tgp, device="cpu")
    return {"jm": jm, "jd": jd, "jgp": jgp, "params": params, "td": td, "tm": tm, "tgp": tgp,
            "hub": hub}


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    return calls


# ------------------------------------------------- positions at T = 1,000
def test_token_buckets_match_at_1000():
    for T in (257, 640, 1000, 1024):
        np.testing.assert_array_equal(tpos.make_token_bucket_position(256, 1024)[:T, :T],
                                      jpos.make_token_bucket_position(256, 1024)[:T, :T])


def test_forward_logits_match_at_1000(env):
    """A 980-byte source (with the template, bos and eos it is cut to
    max_src_length + 1 = 1,001 tokens, padded to 1,008, a multiple of 8)
    and a 61-byte target: learned positions,
    rel-pos buckets, the abs-pos bias and the cross-attention bias at full
    length, on the plain path on both sides."""
    rng = np.random.default_rng(3)
    rec = {"src": _words(rng, 980), "tgt": _words(rng, 61)}
    js = env["jgp"].collate([env["jgp"](JInstruction(SUMMARY, split="train").format(**rec))])
    ts = env["tgp"].collate([env["tgp"](Instruction(SUMMARY, split="train").format(**rec))])
    for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"]):
        np.testing.assert_array_equal(np.asarray(a.value["inputs"]), b.value["inputs"])
    src = ts["net_input"]["slots"][0].value["inputs"]
    assert src.shape[1] == 1008 and (src != env["td"].pad()).sum() == LONG + 1
    load_jax_params(env["tm"].net, env["params"])
    jl, jextra = jax.jit(lambda p, s: env["jm"].net.apply({"params": p}, s))(
        env["params"], js["net_input"]["slots"])
    with torch.no_grad():
        tslots = slots_to_device(ts["net_input"]["slots"], "cpu")
        tl, textra = env["tm"].net(tslots)
        tgt_pos = env["tm"].net.decoder_adaptor([s for s in tslots if not s.is_src]).pos_embed
        src_pos = textra["encoder_out"].pos_embed
        tcb = env["tm"].net.cross_bias(tgt_pos, src_pos)
    jcb = env["jm"].net.apply({"params": env["params"]}, jnp.asarray(tgt_pos.numpy()),
                              jnp.asarray(src_pos.numpy()), method=lambda net, a, b: net.cross_bias(a, b))
    assert tuple(tcb.shape) == (1, 4, 64, 1008)
    for t, j in ((src_pos, jextra["encoder_out"].pos_embed), (tcb, jcb),
                 (textra["encoder_out"].x, jextra["encoder_out"].x), (tl, jl)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0, atol=1e-4)


# ------------------------------------------------------------- serving
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


@pytest.mark.parametrize("opts,seed", [({"beam_size": 1, "max_len_b": 8}, 11),
                                       ({"beam_size": 2, "max_len_b": 6}, SEED_BEAM)],
                         ids=["greedy", "beam2"])
def test_hub_tokens_match_jax_through_flash(env, monkeypatch, opts, seed):
    rng = np.random.default_rng(seed)
    recs = [{"src": _words(rng, int(rng.integers(300, 401)))} for _ in range(3)]
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", _recording_top_k(margins))
    monkeypatch.setattr(jtr, "_flash_available", lambda: True)
    jhub = JOFASys(env["jm"], env["params"], env["jd"], env["jgp"])
    jout = jhub.inference(SUMMARY, recs, **opts)
    monkeypatch.undo()
    assert margins and min(margins) > 1e-3, f"near-tie in the JAX run: {min(margins, default=None)}"

    monkeypatch.setattr(ttr, "flash_available", lambda device: True)
    calls = _count_calls(monkeypatch, tflash, "flash_attention_fwd_reference")
    load_jax_params(env["tm"].net, env["params"])
    tout = env["hub"].inference(SUMMARY, recs, **opts)
    # one flash call per encoder layer; decode steps carry a KV cache and
    # take the plain path
    assert len(calls) == env["tm"].cfg.encoder.layers
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert abs(a.score - b.score) <= 1e-4
        assert a.text == b.text


def test_default_length_cuts_to_257_and_takes_flash(monkeypatch):
    """Under the default max_src_length = 256 a 300-byte source is cut to
    257 tokens (264 with the pad to a multiple of 8): Tk >= 256 opens the
    flash gate (on the card, kernel B3)."""
    d = _dictionary(Dictionary)
    m = GeneralistModel(arch="tiny")
    _configure(m.cfg)
    gp = GeneralPreprocess(d, active=["text"])
    m.initialize(d, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    hub = OFASys(m, None, d, gp, device="cpu")
    srcs = [_words(np.random.default_rng(i), 300 + 50 * i) for i in range(2)]
    sample = gp.collate([gp(Instruction(SUMMARY, split="test").format(src=s)) for s in srcs])
    src = sample["net_input"]["slots"][0].value["inputs"]
    assert src.shape[1] == 264 and (src != d.pad()).sum(1).max() == 257      # padded to 8
    monkeypatch.setattr(ttr, "flash_available", lambda device: True)
    calls = _count_calls(monkeypatch, tflash, "flash_attention_fwd_reference")
    outs = hub.inference(SUMMARY, [{"src": s} for s in srcs], beam_size=1, max_len_b=4)
    assert len(calls) == m.cfg.encoder.layers
    assert all(np.isfinite(o.score) and o.tokens.size > 0 for o in outs)


# (device, Tq, Tk, dropout, bias shape, mask shape, cached, cfg overrides) -> route;
# B = 2, 4 heads of 16, the text path's shared bias and padding mask by default
ROUTES = {
    "flash_at_256": ("cuda", 64, 256, 0.0, None, None, False, {}, "flash"),
    "flash_cross_1000": ("cuda", 62, 1000, 0.0, None, None, False, {}, "flash"),
    "dense_below_256": ("cuda", 128, 255, 0.0, None, None, False, {}, "dense"),
    "dense_flash_off": ("cuda", 128, 256, 0.0, None, None, False, {"use_flash_attention": False},
                        "dense"),
    "plain_small_dispatch": ("cuda", 64, 64, 0.0, None, None, False, {}, "plain"),
    "plain_cached": ("cuda", 1, 300, 0.0, None, None, True, {}, "plain"),
    "plain_dropout": ("cuda", 64, 300, 0.1, None, None, False, {}, "plain"),
    "plain_full_mask": ("cuda", 64, 300, 0.0, None, (2, 1, 64, 300), False, {}, "plain"),
    "dense_per_sample_bias_refused": ("cuda", 128, 128, 0.0, (2, 4, 128, 128), None, False, {},
                                      "plain"),
    "plain_on_cpu": ("cpu", 64, 300, 0.0, None, None, False, {}, "plain"),
    "dense_on_cpu_pallas": ("cpu", 128, 128, 0.0, None, None, False, {"attn_kernel": "pallas"},
                            "dense"),
    "plain_on_cpu_auto": ("cpu", 128, 128, 0.0, None, None, False, {}, "plain"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_attention_route(case):
    """The one routing rule (MultiheadAttention and chip_smoke.py read it):
    flash before dense, as ofasys_tpu; no kernel for a cached decode step,
    attention dropout or a mask that is not padding-only."""
    device, Tq, Tk, p, bias_shape, mask_shape, cached, over, want = ROUTES[case]
    cfg = GeneralistModel(arch="tiny").cfg
    for k, v in over.items():
        setattr(cfg, k, v)
    bias_shape = bias_shape or (1, 4, Tq, Tk)
    mask_shape = mask_shape or (2, 1, 1, Tk)
    got = ttr.attention_route(cfg, device, 2, Tq, Tk, 4, 16, p, bias_shape=bias_shape,
                              mask_shape=mask_shape, cached=cached)
    assert got == want


def test_attention_module_takes_the_routed_path(monkeypatch):
    """MultiheadAttention asks attention_route and runs what it answers: on
    the CPU with the flash gate open, a T = 300 call runs the flash plain
    versions once; closed, the plain attention."""
    cfg = GeneralistModel(arch="tiny").cfg
    attn = ttr.MultiheadAttention(cfg, 64, 4, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 300, 64)).astype(np.float32))
    asked = []
    route = ttr.attention_route
    monkeypatch.setattr(ttr, "attention_route", lambda *a, **kw: asked.append(a) or route(*a, **kw))
    calls = _count_calls(monkeypatch, tflash, "flash_attention_fwd_reference")
    with torch.no_grad():
        plain, _ = attn(x)
        monkeypatch.setattr(ttr, "flash_available", lambda device: True)
        flash, _ = attn(x)
    assert [a[2:5] for a in asked] == [(2, 300, 300)] * 2 and len(calls) == 1
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), rtol=0, atol=1e-4)


# ------------------------------------------------------------ training
def _train_batches(jgp, tgp):
    """Both tasks from the same records, made in the same order on both
    sides (the span-masking rng advances per record)."""
    rng = np.random.default_rng(21)
    infill = [{"text": _words(rng, int(rng.integers(300, 401)))} for _ in range(2)]
    summary = [{"src": _words(rng, int(rng.integers(300, 401))), "tgt": _words(rng, 40)}
               for _ in range(2)]
    jb, tb = {}, {}
    for name, tpl, recs in (("infill", INFILL, infill), ("summary", SUMMARY, summary)):
        js = jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in recs])
        ts = tgp.collate([tgp(Instruction(tpl, split="train").format(**r)) for r in recs])
        for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"]):
            np.testing.assert_array_equal(np.asarray(a.value["inputs"]), b.value["inputs"])
        jb[name] = {"net_input": {"slots": js["net_input"]["slots"]}, "target": jnp.asarray(js["target"])}
        tb[name] = sample_to_device(ts, "cpu")
    return jb, tb


def test_train_update_matches_jax_xla_path(env, monkeypatch):
    jm, params, tm = env["jm"], env["params"], env["tm"]
    jb, tb = _train_batches(env["jgp"], env["tgp"])
    shapes = {n: [s.value["inputs"].shape[1] for s in b["net_input"]["slots"]] for n, b in tb.items()}
    # infill: encoder and decoder past 256 (flash self, causal and cross);
    # summary: a long encoder and a short decoder (flash cross only)
    assert min(shapes["infill"]) >= 256 and shapes["summary"][0] >= 256 > shapes["summary"][1]

    load_jax_params(tm.net, params)
    pad = env["td"].pad()
    jcrit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=pad)
    tcrit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=pad)
    monkeypatch.setattr(ttr, "flash_available", lambda device: True)
    fwd = _count_calls(monkeypatch, tflash, "flash_attention_fwd_reference")
    bwd = _count_calls(monkeypatch, tflash, "flash_attention_bwd_reference")

    # the summed gradients of the update, leaf by leaf
    jgrads, tgrads = None, None
    for i, n in enumerate(("infill", "summary")):
        jg, _, _ = jax.jit(jts.make_grad_step(jm, jcrit, fold=i))(params, 0, jb[n], jax.random.PRNGKey(0))
        tg, _, _ = tts.make_grad_step(tm, tcrit, fold=i)(list(tm.net.parameters()), 0, tb[n], 0)
        jgrads = jg if jgrads is None else jax.tree.map(jnp.add, jgrads, jg)
        tgrads = tg if tgrads is None else [a + b for a, b in zip(tgrads, tg)]
    # 3 flash calls per infill layer pair (encoder self; decoder self and
    # cross), 1 per summary decoder layer (cross) plus its encoder's
    L = tm.cfg.encoder.layers
    assert len(fwd) == len(bwd) == 3 * L + 2 * L
    names = [n for n, _ in tm.net.named_parameters()]
    flat_t = jax.tree_util.tree_leaves_with_path(export_params(tm.net, dict(zip(names, tgrads))))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        b = np.asarray(flat_j[path], np.float32)
        ref = np.abs(b).max()
        if path[-1].key == "bias" and path[-2].key in NOISE_MODULES:
            # exact gradient 0: bounded by its kernel's gradient
            ref = KEY_BIAS_FRACTION * np.abs(np.asarray(flat_j[path[:-1] + (jax.tree_util.DictKey("kernel"),)])).max()
        err, tol = np.abs(a - b).max(), GRAD_ATOL + GRAD_RTOL * ref
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)

    # one summed two-task update: losses and gnorm
    jopt = jbuild_optimizer(JOptimizationConfig(lr=(1e-3,)), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(lr=(1e-3,)), total_num_update=10)
    jstep = jax.jit(jts.make_multitask_train_step(jm, {"infill": jcrit, "summary": jcrit}, jopt))
    tstep = tts.make_multitask_train_step(tm, {"infill": tcrit, "summary": tcrit}, topt)
    _, jmet = jstep(jts.TrainState.create(params, jopt), jb, jax.random.PRNGKey(0))
    _, tmet = tstep(tts.TrainState.create(tm.net, topt), tb, 0)
    np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]), rtol=LOSS_RTOL)
    for n in ("infill", "summary"):
        for key in ("loss", "nll_loss", "sample_size"):
            np.testing.assert_allclose(float(tmet["tasks"][n][key]), float(jmet["tasks"][n][key]),
                                       rtol=LOSS_RTOL)
