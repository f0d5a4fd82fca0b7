"""The LayerNorm kernels of ofasys_torch (B6-fwd, B6-bwd) and the
``ln_impl='pallas'|'hybrid'`` configurations against ofasys_tpu.

Kernel level: the plain versions (what the wrappers run on CPU tensors)
against ``fused_layer_norm`` (the Pallas kernels in interpret mode) and
``hybrid_layer_norm`` (XLA forward, Pallas backward), forward and
``jax.vjp`` gradients, at E = 768 and 3,072 (``fc2_ln``), a ragged N, and
E = 1,024 and 4,096 (the large arch's width and FFN width, where B6-bwd's
plan takes groups of two and six warps) at N = 300, in fp32 and bf16. Tolerances:
  * fp32: y, mu and rstd rtol/atol 1e-5 (fp32 row sums in another order);
    dx rtol/atol 1e-4 and dg, db rtol/atol 2e-4 (as
    tests/test_pallas_layernorm.py holds the Pallas gradients; dg and db
    are sums over up to 300 rows);
  * bf16: y and dx within one bf16 ulp (rtol 2^-7) plus atol 1e-3 for
    entries near 0, where the fp32 values before rounding differ by fp32
    noise; mu and rstd as fp32; dg and db (fp32 sums of the same bf16
    inputs) rtol/atol 1e-3.
Where N is not a multiple of the Pallas row block, ``_ln_backward``'s dg
comes out NaN in interpret mode: it zeroes dy on the padded rows but not
xhat, and 0 * NaN is NaN. There dg and db are held against ``jax.vjp`` of
FusedLayerNorm's plain math instead (what the module runs off the TPU);
the port's kernel takes ragged N without padding.

Model level: tiny arch (2+2 layers, E=64, FFN 256), fp32, dropout 0, the
same parameters on both sides. ofasys_tpu's FusedLayerNorm falls back to
its plain math off the TPU, the same function as the port's plain
versions. Logits atol 1e-5; one summed two-task update: losses rtol 1e-4,
gradients atol 1e-5 + rtol 1e-3 of the leaf's largest entry, parameters
after the update within 2 lr (as tests/test_torch_train_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.model.config import GeneralistModelConfig as JConfig
from ofasys_tpu.model.transformer import make_ln as jmake_ln
from ofasys_tpu.ops.pallas_layernorm import (
    FusedLayerNorm as JFusedLayerNorm,
    _ln_forward,
    fused_layer_norm,
    hybrid_layer_norm,
)
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.model.transformer import LayerNorm, make_ln
from ofasys_torch.ops import layer_norm as tln
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device, slots_to_device

EPS = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(256, 768), (300, 3072), (77, 768), (300, 1024), (300, 4096)]
SHAPE_IDS = ["E768", "fc2_ln_E3072", "ragged_N77", "E1024", "E4096"]
INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(N, E, dtype, seed=0):
    """x (with a mean offset, as a residual stream has), g, b and a
    cotangent dy, as JAX arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray((rng.standard_normal((N, E)) * 2.0 + 0.5).astype(np.float32)).astype(jdt)
    dy = jnp.asarray(rng.standard_normal((N, E)).astype(np.float32)).astype(jdt)
    g = (rng.standard_normal(E) * 0.3 + 1.0).astype(np.float32)
    b = (rng.standard_normal(E) * 0.1).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(tdt)

    return (x, jnp.asarray(g), jnp.asarray(b), dy), (t(x), torch.from_numpy(g), torch.from_numpy(b), t(dy))


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if what in ("y", "dx") and dtype == "bf16":
        rtol, atol = 2.0 ** -7, 1e-3
    elif what in ("dg", "db"):
        rtol = atol = 2e-4 if dtype == "fp32" else 1e-3
    elif what == "dx":
        rtol = atol = 1e-4
    else:
        rtol = atol = 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,E", SHAPES, ids=SHAPE_IDS)
def test_forward_plain_version_matches_pallas(N, E, dtype):
    (jx, jg, jb, _), (x, g, b, _) = _inputs(N, E, dtype)
    jy, jmu, jrstd = _ln_forward(jx, jg, jb, EPS, return_stats=True)
    y, mu, rstd = tln.layer_norm_fwd(x, g, b, EPS)          # CPU: the plain version
    assert y.dtype == x.dtype and mu.shape == (N, 1) and rstd.dtype == torch.float32
    _close(y, jy, dtype, "y")
    _close(mu, jmu, dtype, "mu")
    _close(rstd, jrstd, dtype, "rstd")
    hy = hybrid_layer_norm(jx, jg, jb, EPS)
    _close(tln.HybridLayerNormFunction.apply(x, g, b, EPS), hy, dtype, "y")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N,E", SHAPES, ids=SHAPE_IDS)
def test_backward_plain_version_matches_pallas_vjp(N, E, dtype):
    (jx, jg, jb, jdy), (x, g, b, dy) = _inputs(N, E, dtype, seed=1)
    _, vjp = jax.vjp(lambda x, g, b: fused_layer_norm(x, g, b, EPS), jx, jg, jb)
    jdx, jdg, jdb = vjp(jdy)
    block = min(256, -(-N // 8) * 8)                    # _ln_backward's row block
    if N % block:                                       # its dg is NaN here (module docstring)
        module = JFusedLayerNorm(epsilon=EPS)
        _, vjp = jax.vjp(lambda x, g, b: module.apply({"params": {"scale": g, "bias": b}}, x),
                         jx, jg, jb)
        _, jdg, jdb = vjp(jdy)
    _, mu, rstd = tln.layer_norm_fwd(x, g, b, EPS)
    dx, dg, db = tln.layer_norm_bwd(x, g, mu, rstd, dy)     # CPU: the plain version
    assert dx.dtype == x.dtype and dg.dtype == db.dtype == torch.float32
    for name, got, want in (("dx", dx, jdx), ("dg", dg, jdg), ("db", db, jdb)):
        _close(got, want, dtype, name)

    # the autograd functions, fused (B6-fwd, B6-bwd) and hybrid (plain
    # forward, B6-bwd), against hybrid_layer_norm's vjp (dx) and the above
    _, hvjp = jax.vjp(lambda x, g, b: hybrid_layer_norm(x, g, b, EPS), jx, jg, jb)
    want = (hvjp(jdy)[0], jdg, jdb)
    for fn in (tln.FusedLayerNormFunction, tln.HybridLayerNormFunction):
        xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
        fn.apply(xs, gs, bs, EPS).backward(dy)
        for name, got, w in zip(("dx", "dg", "db"), (xs.grad, gs.grad, bs.grad), want):
            _close(got, w, dtype, name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """The plain backward's formula is the gradient of the plain forward
    (both compute in fp32: within fp32 noise)."""
    (_, _, _, _), (x, g, b, dy) = _inputs(40, 96, "fp32", seed=2)
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    y, _, _ = tln.layer_norm_fwd_reference(xs, gs, bs, EPS)
    y.backward(dy)
    _, mu, rstd = tln.layer_norm_fwd_reference(x, g, b, EPS)
    for got, want in zip(tln.layer_norm_bwd_reference(x, g, mu, rstd, dy), (xs.grad, gs.grad, bs.grad)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="fp32"):
        tln.layer_norm_fwd(x, torch.ones(8, dtype=torch.float64), torch.zeros(8), EPS)
    with pytest.raises(ValueError, match="contiguous"):
        tln.layer_norm_fwd(torch.zeros(8, 4).t(), torch.ones(8), torch.zeros(8), EPS)
    with pytest.raises(ValueError, match=r"\(4, 1\)"):
        tln.layer_norm_bwd(x, torch.ones(8), torch.zeros(4), torch.ones(4, 1), x)


# ------------------------------------------------------------------- config
def test_unknown_ln_impl_raises_as_in_jax():
    with pytest.raises(ValueError, match="ln_impl"):
        jmake_ln(JConfig(arch="tiny", ln_impl="hybird"), jnp.float32, "ln")
    with pytest.raises(ValueError, match="ln_impl"):
        make_ln(GeneralistModelConfig(arch="tiny", ln_impl="hybird"), 64, torch.float32)
    m = GeneralistModel(arch="tiny", ln_impl="hybird")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 1
    with pytest.raises(ValueError, match="ln_impl"):
        m.initialize(_dictionary(Dictionary), device="cpu")


@pytest.mark.parametrize("impl,mode", [("pallas", "fused"), ("hybrid", "hybrid")])
def test_ln_impl_builds_b6_at_the_sites_jax_does(impl, mode):
    """The stacks' LayerNorms (encoder 4 per layer + 1, decoder 6 per layer
    + 1: 62 at the base arch's 6+6 layers) become FusedLayerNorm; the
    adaptors' stay plain; init and export treat them as LayerNorms."""
    m = GeneralistModel(arch="tiny", ln_impl=impl)
    m.cfg.encoder.layers = m.cfg.decoder.layers = 6
    m.initialize(_dictionary(Dictionary), device="cpu")
    fused = [n for n, mod in m.net.named_modules() if isinstance(mod, tln.FusedLayerNorm)]
    plain = [n for n, mod in m.net.named_modules()
             if isinstance(mod, LayerNorm) and not isinstance(mod, tln.FusedLayerNorm)]
    assert len(fused) == 6 * 4 + 1 + 6 * 6 + 1 == 62
    assert all(m.net.get_submodule(n).mode == mode for n in fused)
    assert plain and all("adaptor" in n for n in plain)
    ln = m.net.get_submodule(fused[0])
    assert torch.equal(ln.weight, torch.ones_like(ln.weight))
    tree = export_params(m.net)
    assert set(tree["encoder"]["layers_0"]["final_layer_norm"]) == {"scale", "bias"}


# -------------------------------------------------------------------- model
def _configure(m, impl):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = 0.0
    c.ln_impl = impl


def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _perturb(params, seed=0):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        name = path[-1].key
        if name == "rel_pos_table":
            return 0.3 * noise
        if name in ("bias", "type_embedding"):
            return a + 0.05 * noise
        if name == "scale":
            return a + 0.1 * noise
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def _records(seed):
    rng = np.random.default_rng(seed)
    words = ["the", "model", "learns", "to", "fill", "in", "masked", "spans", "of", "text"]

    def text(n):
        s = ""
        while len(s) < n:
            s += rng.choice(words) + " "
        return s[:n].strip()

    infill = [{"text": text(int(rng.integers(30, 46)))} for _ in range(4)]
    summary = [{"src": text(int(rng.integers(50, 70))), "tgt": text(int(rng.integers(20, 30)))}
               for _ in range(4)]
    return {"infill": (INFILL, infill), "summary": (SUMMARY, summary)}


@pytest.fixture(scope="module")
def jax_side():
    """ofasys_tpu at ln_impl='pallas' (its FusedLayerNorm's plain math on
    the CPU): batches, parameters, one update's gradients and the update."""
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _configure(jm, "pallas")
    jgp = JGeneralPreprocess(jd, active=["text"])
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    batches = {n: jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in recs])
               for n, (tpl, recs) in _records(7).items()}
    params = _perturb(jm.init_params(jax.random.PRNGKey(0), batches["summary"]["net_input"]["slots"]))
    jbatch = {n: {"net_input": b["net_input"], "target": jnp.asarray(b["target"])}
              for n, b in batches.items()}
    logits, _ = jm.apply(params, batches["summary"]["net_input"]["slots"])
    crit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=jd.pad())
    grads = None
    for i, n in enumerate(("infill", "summary")):
        g, _, _ = jax.jit(jts.make_grad_step(jm, crit, fold=i))(params, 0, jbatch[n], jax.random.PRNGKey(0))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    opt = jbuild_optimizer(JOptimizationConfig(lr=(LR,)), total_num_update=10)
    step = jax.jit(jts.make_multitask_train_step(jm, {"infill": crit, "summary": crit}, opt))
    state, met = step(jts.TrainState.create(params, opt), jbatch, jax.random.PRNGKey(0))
    return dict(params=params, logits=np.asarray(logits), grads=jax.device_get(grads),
                met=jax.device_get(met), new_params=jax.device_get(state.params), pad=jd.pad())


def _tree_close(t, j, atol, rtol):
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j))
    flat_t = jax.tree_util.tree_leaves_with_path(t)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        b = np.asarray(flat_j[path], np.float32)
        err, tol = np.abs(a - b).max(), atol + rtol * np.abs(b).max()
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_ln_impl_model_and_train_step_match_jax(jax_side, impl):
    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _configure(tm, impl)
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    load_jax_params(tm.net, jax_side["params"])
    batches = {n: sample_to_device(tgp.collate([tgp(Instruction(tpl, split="train").format(**r))
                                                for r in recs]), "cpu")
               for n, (tpl, recs) in _records(7).items()}
    calls = []
    orig = tln.layer_norm_bwd_reference
    tln.layer_norm_bwd_reference = lambda *a: calls.append(1) or orig(*a)
    try:
        logits, _ = tm.apply(slots_to_device(batches["summary"]["net_input"]["slots"], "cpu"))
        np.testing.assert_allclose(logits.numpy(), jax_side["logits"], rtol=0, atol=1e-5)

        crit = LabelSmoothedCrossEntropyCriterion(
            LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=jax_side["pad"])
        names = [n for n, _ in tm.net.named_parameters()]
        grads = None
        for i, n in enumerate(("infill", "summary")):
            g, _, _ = tts.make_grad_step(tm, crit, fold=i)(list(tm.net.parameters()), 0, batches[n], 0)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        _tree_close(export_params(tm.net, dict(zip(names, grads))), jax_side["grads"], 1e-5, 1e-3)
        # the backward went through B6-bwd's plain version at every stack
        # LayerNorm: 2 tasks x (2 * 4 + 1 + 2 * 6 + 1)
        assert len(calls) == 2 * 22

        opt = build_optimizer(OptimizationConfig(lr=(LR,)), total_num_update=10)
        step = tts.make_multitask_train_step(tm, {"infill": crit, "summary": crit}, opt)
        _, met = step(tts.TrainState.create(tm.net, opt), batches, 0)
    finally:
        tln.layer_norm_bwd_reference = orig
    for n in ("infill", "summary"):
        for key in ("loss", "nll_loss", "sample_size"):
            np.testing.assert_allclose(float(met["tasks"][n][key]),
                                       float(jax_side["met"]["tasks"][n][key]), rtol=1e-4)
    np.testing.assert_allclose(float(met["gnorm"]), float(jax_side["met"]["gnorm"]), rtol=1e-4)
    _tree_close(export_params(tm.net), jax_side["new_params"], 2 * LR, 0.0)
