"""The chunked-vocab fused cross entropy (ofasys_torch/ops/fused_ce.py and
the criterion's ``chunked_vocab`` path) against ofasys_tpu's, at the
tolerances of ofasys_tpu's own tests (tests/test_fused_ce.py):
  * ``chunked_ce_stats`` forward against JAX's and against the dense
    statistics: lse and z_t rtol 2e-5, the row sum rtol 1e-4 + atol 1e-3,
    in fp32 and bf16;
  * its gradients (x and the table) against JAX's chunked ones and the
    dense ones, fp32: rtol 2e-4 + atol 2e-5;
  * the fused criterion against the unfused one on the same tiny model
    (2+2 layers, a vocabulary padded to 1,024, which ``pick_chunks``
    cuts in 2 chunks): loss and nll rtol 1e-5, every parameter gradient rtol
    5e-4 + atol 1e-5; and against ofasys_tpu's fused criterion on the same
    parameters: loss rtol 1e-5, gradients rtol 5e-4 + atol 1e-5;
  * the gates decline where JAX's do (accuracy reporting, constraint
    masks, a float target, an untied output projection, a non-TEXT target).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JModalityType
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JConfig,
)
from ofasys_tpu.ops.fused_ce import chunked_ce_stats as jchunked, pick_chunks as jpick
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, ModalityType
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.ops.fused_ce import chunked_ce_stats, pick_chunks
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("V", [50048, 51200, 1024, 127, 128, 384, 50000, 4096 * 3])
def test_pick_chunks_matches(V):
    assert pick_chunks(V) == jpick(V)


def test_pick_chunks_base_vocabulary():
    assert pick_chunks(50048) == 17 and 50048 // 17 == 2944


def _dense_stats(x2, emb, tgt, dtype):
    s = (x2.to(dtype) @ emb.to(dtype).t()).to(dtype).float()
    return torch.logsumexp(s, dim=-1), torch.gather(s, 1, tgt[:, None])[:, 0], s.sum(dim=-1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_chunked_stats_forward(dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(0)
    N, E, V = 64, 32, 512
    x = rng.standard_normal((N, E)).astype(np.float32)
    emb = (rng.standard_normal((V, E)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, N)
    jx = jnp.asarray(x, jdt)
    want = jax.jit(lambda a, w: jchunked(a, w, jnp.asarray(tgt, jnp.int32), 4, jdt))(jx, jnp.asarray(emb))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    got = chunked_ce_stats(tx, torch.tensor(emb), torch.tensor(tgt), 4, tdt)
    dense = _dense_stats(tx, torch.tensor(emb), torch.tensor(tgt), tdt)
    for ref in ([np.asarray(a) for a in want], [a.numpy() for a in dense]):
        np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=2e-5)
        np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=1e-4, atol=1e-3)


def test_chunked_stats_gradients():
    rng = np.random.default_rng(1)
    N, E, V = 48, 32, 384
    x = rng.standard_normal((N, E)).astype(np.float32)
    emb = (rng.standard_normal((V, E)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, N)
    gl, gt = rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32)
    gs = (rng.standard_normal(N) * 0.01).astype(np.float32)

    def jloss(a, w):
        lse, z_t, zsum = jchunked(a, w, jnp.asarray(tgt, jnp.int32), 3, jnp.float32)
        return jnp.sum(lse * gl + z_t * gt + zsum * gs)

    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(emb))
    refs = [(np.asarray(jgx), np.asarray(jgw))]
    for fn in (lambda a, w: chunked_ce_stats(a, w, torch.tensor(tgt), 3, torch.float32),
               lambda a, w: _dense_stats(a, w, torch.tensor(tgt), torch.float32)):
        a, w = torch.tensor(x, requires_grad=True), torch.tensor(emb, requires_grad=True)
        lse, z_t, zsum = fn(a, w)
        (lse * torch.tensor(gl) + z_t * torch.tensor(gt) + zsum * torch.tensor(gs)).sum().backward()
        refs.append((a.grad.numpy(), w.grad.numpy()))
    got = refs.pop(1)   # the port's chunked gradients against JAX's and the dense ones
    for ref in refs:
        np.testing.assert_allclose(got[0], ref[0], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got[1], ref[1], rtol=2e-4, atol=2e-5)


# -------------------------------------------------------------- end to end
def _dictionary(cls):
    d = cls()
    for i in range(900):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(1024)
    return d


def _batch(d, rng, cls, mod, B=4, T=8, to=np.asarray):
    toks = rng.integers(d.nspecial, d.nspecial + 50, size=(B, T - 1)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), d.bos(), np.int32), toks], axis=1)
    target = np.concatenate([toks, np.full((B, 1), d.eos(), np.int32)], axis=1)
    src = cls(mod.TEXT, True, {"inputs": to(toks)}, "src")
    tgt = cls(mod.TEXT, False, {"inputs": to(prev)}, "tgt")
    return {"net_input": {"slots": [src, tgt]}, "target": to(target)}


@pytest.fixture(scope="module")
def models():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    jm.cfg.encoder.layers = jm.cfg.decoder.layers = 2
    jm.cfg.dropout = 0.0
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    jb = _batch(jd, np.random.default_rng(0), JSlotBatch, JModalityType, to=jnp.asarray)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), jb["net_input"]["slots"]))
    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    tm.cfg.encoder.layers = tm.cfg.decoder.layers = 2
    tm.cfg.dropout = 0.0
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    load_jax_params(tm.net, params)
    tb = _batch(td, np.random.default_rng(0), SlotBatch, ModalityType,
                to=lambda a: torch.tensor(a, dtype=torch.long))
    return {"jm": jm, "jd": jd, "params": params, "jb": jb, "tm": tm, "td": td, "tb": tb}


def _port_loss_grads(env, chunked, **cfg):
    tm, td = env["tm"], env["td"]
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1, chunked_vocab=chunked, **cfg),
        pad_id=td.pad())
    names, params = zip(*tm.net.named_parameters())
    loss, ss, log = crit(tm, env["tb"], torch.Generator().manual_seed(0), train=True)
    loss = loss / torch.clamp(ss, min=1.0)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return float(loss), log, export_params(tm.net, dict(zip(names, grads)))


def _leaves_close(got, want, rtol, atol):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def test_fused_criterion_matches_unfused_and_jax(models):
    env = models
    assert pick_chunks(len(env["td"])) == 2
    l0, log0, g0 = _port_loss_grads(env, False)
    l1, log1, g1 = _port_loss_grads(env, True)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(float(log1["nll_loss"]), float(log0["nll_loss"]), rtol=1e-5)
    assert int(log1["ntokens"]) == int(log0["ntokens"])
    _leaves_close(g1, g0, 5e-4, 1e-5)

    jcrit = JCriterion(JConfig(label_smoothing=0.1, chunked_vocab=True), pad_id=env["jd"].pad())

    def f(p):
        loss, ss, logging = jcrit(env["jm"], {"params": p}, env["jb"], rng=None, train=True)
        return loss / jnp.maximum(ss, 1.0)

    jl, jg = jax.jit(jax.value_and_grad(f))(env["params"])
    np.testing.assert_allclose(l1, float(jl), rtol=1e-5)
    _leaves_close(g1, jax.device_get(jg), 5e-4, 1e-5)


def test_fused_path_skips_the_logits(models, monkeypatch):
    """Under the fused plan the model stops at the decoder's hidden states:
    the tied projection (``Embed.attend``) never runs."""
    from ofasys_torch.model import transformer

    calls = []
    orig = transformer.Embed.attend
    monkeypatch.setattr(transformer.Embed, "attend", lambda self, *a: calls.append(1) or orig(self, *a))
    _port_loss_grads(models, True)
    assert not calls
    _port_loss_grads(models, False)
    assert calls


def test_fused_plan_gates(models):
    env = models
    tm, tb = env["tm"], env["tb"]
    crit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(chunked_vocab=True),
                                              pad_id=env["td"].pad())
    assert crit._fused_plan(tm, tb) == 2
    off = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(), pad_id=1)
    assert off._fused_plan(tm, tb) is None
    acc = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(chunked_vocab=True, report_accuracy=True), pad_id=1)
    assert acc._fused_plan(tm, tb) is None
    V = len(env["td"])
    assert crit._fused_plan(tm, {**tb, "constraint_masks": torch.ones(4, 8, V, dtype=torch.bool)}) is None
    assert crit._fused_plan(tm, {**tb, "target": tb["target"].float()}) is None
    slots = tb["net_input"]["slots"]
    img = [s if s.is_src else dataclasses.replace(s, modality=ModalityType.IMAGE) for s in slots]
    assert crit._fused_plan(tm, {**tb, "net_input": {"slots": img}}) is None
    for leaf in ("output_projection", "output_projection_bias"):
        fake = torch.nn.Module()
        fake.register_parameter(leaf, torch.nn.Parameter(torch.zeros(4)))
        tm.net.add_module("decoder_adaptor_fake", fake)
        try:
            assert crit._fused_plan(tm, tb) is None
        finally:
            del tm.net.decoder_adaptor_fake
    assert crit._fused_plan(tm, tb) == 2


def test_fused_loss_with_reductions(models):
    """ignore_eos, sentence_avg and drop_worst ride on the fused statistics
    as on the unfused ones."""
    for cfg in (dict(ignore_eos=True), dict(sentence_avg=True),
                dict(drop_worst_ratio=0.3, drop_worst_after=-1)):
        l0, log0, _ = _port_loss_grads(models, False, **cfg)
        l1, log1, _ = _port_loss_grads(models, True, **cfg)
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        assert int(log1["ntokens"]) == int(log0["ntokens"])
