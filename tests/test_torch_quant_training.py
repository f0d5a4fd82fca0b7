"""Int8 quantized training (``quant_training='fwd'``) against ofasys_tpu:
``ops/quant.int8_train_matmul`` and the transformer's ``qtrain``.

  * The forward is bit-equal to ofasys_tpu's ``_int8_fwd_value`` on the same
    inputs (bf16 and fp32 x; the port's weight is JAX's kernel transposed),
    as JAX runs it op by op: ``(acc * sx) * scale`` in fp32. Under ``jit``
    XLA fuses that epilogue and can move an fp32 result by one ulp; the
    bf16 outputs of the jitted function are the port's too.
  * The backward is straight-through: against JAX's VJP, fp32 rtol 1e-5 +
    atol 1e-6; bf16 within one bf16 ulp of the largest entry (both round a
    bf16 product with fp32 accumulation, in another order).
  * Under ``fuse_qkv`` the concatenated q/k/v weight through one call
    equals three calls bit for bit (per-output-channel scales).
  * Eval and decode calls are bit-identical to ``quant_training='none'``.
  * A training forward quantizes 4 projections per encoder layer and 7 per
    decoder layer (counted through B7's wrapper).
  * One summed update of the tiny fp32 model (2+2 layers): loss and
    gradients against ofasys_tpu's at the same parameters: loss rtol 1e-4,
    gradients atol 1e-5 + rtol 1e-3 of each leaf's largest entry (the
    tolerances of tests/test_torch_train_step.py).
  * 30 adam updates track the unquantized run as ofasys_tpu's test asks
    (final eval loss < exact's * 1.25 + 0.25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JModalityType
from ofasys_tpu.ops.quant import _int8_fwd_value, int8_train_matmul as jint8_train
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, ModalityType
from ofasys_torch.model.config import QUANT_TRAINING
from ofasys_torch.ops import quant
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, M=24, K=64, N=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)    # JAX (in, out)
    return x, w


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_bit_equal(seed, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x, w = _operands(seed)
    jx = jnp.asarray(x, jdt)
    want = np.asarray(_int8_fwd_value(jx, jnp.asarray(w)).astype(jnp.float32))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    got = quant.int8_train_matmul(tx, torch.tensor(w.T.copy()))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == "bf16":
        # jitted, XLA fuses the fp32 epilogue and may move it by an fp32 ulp;
        # the bf16 output is the same
        jitted = jax.jit(_int8_fwd_value)(jx, jnp.asarray(w)).astype(jnp.float32)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jitted))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_backward_straight_through(dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    x, w = _operands(3)
    g = np.random.default_rng(4).standard_normal((x.shape[0], w.shape[1])).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    _, vjp = jax.vjp(jint8_train, jx, jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_()
    tw = torch.tensor(w.T.copy(), requires_grad=True)
    tg = torch.tensor(np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))).to(tdt)
    quant.int8_train_matmul(tx, tw).backward(tg)
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    for got, want in ((tx.grad.float().numpy(), np.asarray(jdx.astype(jnp.float32))),
                      (tw.grad.numpy(), np.asarray(jdw).T)):
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -8 * np.abs(want).max())


def test_fused_qkv_equals_separate_calls():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 9, 64)), dtype=torch.bfloat16)
    ws = [torch.tensor(rng.standard_normal((64, 64)) * 0.1, dtype=torch.float32) for _ in range(3)]
    fused = quant.int8_train_matmul(x, torch.cat(ws, dim=0))
    parts = torch.cat([quant.int8_train_matmul(x, w) for w in ws], dim=-1)
    assert torch.equal(fused, parts)


# ---------------------------------------------------------------- models
def _dictionary(cls):
    d = cls()
    for i in range(64):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _configure(m, qt):
    m.cfg.encoder.layers = m.cfg.decoder.layers = 2
    m.cfg.dropout = 0.0
    m.cfg.quant_training = qt


def _slots(d, cls, mod, to):
    r = np.random.default_rng(1)
    toks = r.integers(d.nspecial, d.nspecial + 50, size=(4, 10)).astype(np.int32)
    tgt = r.integers(d.nspecial, d.nspecial + 50, size=(4, 6)).astype(np.int32)
    prev = np.concatenate([np.full((4, 1), d.bos(), np.int32), tgt[:, :-1]], 1)
    return [cls(mod.TEXT, True, {"inputs": to(toks)}, "src"),
            cls(mod.TEXT, False, {"inputs": to(prev)}, "tgt")], to(tgt)


@pytest.fixture(scope="module")
def pair():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _configure(jm, "fwd")
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    jslots, jtgt = _slots(jd, JSlotBatch, JModalityType, jnp.asarray)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), jslots))
    td = _dictionary(Dictionary)
    models = {}
    for qt in ("fwd", "none"):
        tm = GeneralistModel(arch="tiny")
        _configure(tm, qt)
        tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
        load_jax_params(tm.net, params)
        models[qt] = tm
    tslots, ttgt = _slots(td, SlotBatch, ModalityType, lambda a: torch.tensor(a, dtype=torch.long))
    return dict(jm=jm, params=params, jslots=jslots, jtgt=jtgt, models=models, tslots=tslots, ttgt=ttgt)


def test_config_accepts_fwd_and_none_only():
    assert QUANT_TRAINING == ("none", "fwd")
    for qt in QUANT_TRAINING:
        m = GeneralistModel(arch="tiny")
        _configure(m, qt)
        m.initialize(_dictionary(Dictionary), active_adaptors=("text",), device="cpu")
    m = GeneralistModel(arch="tiny")
    _configure(m, "int4")
    with pytest.raises(ValueError, match="quant_training"):
        m.initialize(_dictionary(Dictionary), active_adaptors=("text",), device="cpu")


def test_eval_and_decode_are_exact(pair):
    q, e = pair["models"]["fwd"], pair["models"]["none"]
    lq, _ = q.apply(pair["tslots"])
    le, _ = e.apply(pair["tslots"])
    assert torch.equal(lq, le)
    # a training call without a generator is deterministic, so unquantized too
    tq, _ = q.apply_train(pair["tslots"], deterministic=True)
    assert torch.equal(tq, le)


def test_training_forward_quantizes_every_projection(pair, monkeypatch):
    calls = []
    orig = quant.int8_matmul_fwd
    monkeypatch.setattr(quant, "int8_matmul_fwd", lambda *a: calls.append(a[2].shape) or orig(*a))
    q = pair["models"]["fwd"]
    q.apply_train(pair["tslots"], generator=torch.Generator().manual_seed(0))
    cfg = q.cfg
    assert len(calls) == 4 * cfg.encoder.layers + 7 * cfg.decoder.layers
    E = cfg.encoder.embed_dim
    assert calls.count((3 * E, E)) == cfg.encoder.layers + cfg.decoder.layers   # fused self q/k/v
    assert calls.count((2 * E, E)) == cfg.decoder.layers                        # fused cross k/v


def _jloss(jm, p, slots, tgt, train):
    logits, _ = jm.apply(p, slots, deterministic=not train)
    lp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.take_along_axis(lp, tgt[..., None], axis=-1).mean()


def _tloss(tm, slots, tgt, train):
    logits, _ = tm.apply_train(slots, deterministic=not train,
                               generator=torch.Generator().manual_seed(0) if train else None)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, tgt[..., None]).mean()


def test_one_update_loss_and_gradients_match_jax(pair):
    jl, jg = jax.value_and_grad(lambda p: _jloss(pair["jm"], p, pair["jslots"], pair["jtgt"], True))(
        pair["params"])
    tm = pair["models"]["fwd"]
    names, params = zip(*tm.net.named_parameters())
    tl = _tloss(tm, pair["tslots"], pair["ttgt"], True)
    grads = torch.autograd.grad(tl, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for n, g, p in zip(names, grads, params)}
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    got = jax.tree_util.tree_leaves(export_params(tm.net, grads))
    want = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 + 1e-3 * np.abs(b).max())
    # and the quantized forward differs from the exact one (it is quantized)
    assert float(tl) != float(_tloss(pair["models"]["none"], pair["tslots"], pair["ttgt"], True))


def test_quantized_training_tracks_exact(pair):
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.optim import build_optimizer

    finals = {}
    for qt in ("fwd", "none"):
        tm = GeneralistModel(arch="tiny")
        _configure(tm, qt)
        tm.initialize(pair["models"]["none"].global_dict, active_adaptors=("text",),
                      dtype=torch.float32, device="cpu")
        load_jax_params(tm.net, pair["params"])
        params = list(tm.net.parameters())
        opt = build_optimizer(OptimizationConfig(lr=(3e-3,), clip_norm=0.0, lr_scheduler="fixed"))
        state = opt.init(params)
        for _ in range(30):
            grads = torch.autograd.grad(_tloss(tm, pair["tslots"], pair["ttgt"], True), params,
                                        allow_unused=True)
            state = opt.step(params, [torch.zeros_like(p) if g is None else g
                                      for g, p in zip(grads, params)], state)
        with torch.no_grad():
            finals[qt] = float(_tloss(tm, pair["tslots"], pair["ttgt"], False))
    assert np.isfinite(finals["fwd"])
    assert finals["fwd"] < finals["none"] * 1.25 + 0.25, finals
