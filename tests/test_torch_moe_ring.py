"""The port's expert-parallel MoE and ring attention against ofasys_tpu's
(tests/test_moe_ring.py's sizes and tolerances).

The JAX side runs in this process on the pytest run's eight virtual CPU devices;
the port's ranks are a world of four spawned gloo processes
(``ofasys_torch.parallel.distributed.World``, started once for the file)
that run tests/torch_parallel_ranks.py and import neither jax nor
ofasys_tpu. Ring attention runs through the plain block and, with
``use_flash=True``, through the flash kernels' plain versions (JAX: its
Pallas flash kernel in interpret mode); the bias tests draw a bias exact in
bf16, the flash kernels' bias format.

ofasys_tpu's ``moe_ffn_sharded`` matches its dense path only where every
rank holds one expert (E / ep = 1): with several experts a rank, its
reshape before the second ``all_to_all`` returns the buffers to the wrong
(expert, source) rows (max |out - dense| 0.29 at E = 8, ep = 2 with no
token dropped). The port keeps the layout; it is held against ofasys_tpu at
E / ep = 1 and against its own dense path (exactly) at E / ep = 4 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.configure.configs import ParallelConfig as JParallelConfig
from ofasys_tpu.ops.attention import causal_mask as jcausal_mask, dot_product_attention
from ofasys_tpu.parallel import build_mesh as jbuild_mesh
from ofasys_tpu.parallel.moe import moe_ffn_dense as jmoe_dense, moe_ffn_sharded as jmoe_sharded
from ofasys_tpu.parallel.moe import top1_routing as jtop1
from ofasys_tpu.parallel.ring_attention import ring_attention as jring
from ofasys_torch.parallel.distributed import World
from ofasys_torch.parallel.moe import moe_ffn_dense, top1_routing

import torch_parallel_ranks as R

RING_RTOL, RING_ATOL = 2e-4, 2e-4        # tests/test_moe_ring.py
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-3
BF16_ROUNDING = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with World(4) as w:
        yield w


def _jmesh(pcfg, n=4):
    return jbuild_mesh(JParallelConfig(**pcfg), devices=jax.devices()[:n])


def test_top1_routing_slots():
    logits = np.asarray([[9.0, 0.0], [9.0, 0.0], [0.0, 9.0], [9.0, 0.0]], np.float32)
    idx, gate, slot = top1_routing(torch.as_tensor(logits), capacity=2)
    jidx, jgate, jslot = jtop1(jnp.asarray(logits), capacity=2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6)


def _moe_inputs(seed, N, D, H, E):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, D, H)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, H, D)) * 0.1).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def test_moe_dense_matches_jax():
    """moe_ffn_dense: output, aux and the gradients of every input."""
    x, rw, w1, w2, g = _moe_inputs(0, 32, 16, 32, 4)

    def jloss(*a):
        out, aux = jmoe_dense(*a, capacity_factor=2.0)
        return (out * g).sum() + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (x, rw, w1, w2)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, rw, w1, w2)]
    out, aux = moe_ffn_dense(*ts, capacity_factor=2.0)
    tg = torch.autograd.grad((out * torch.as_tensor(g)).sum() + aux, ts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_moe_sharded_matches_jax(world):
    """expert=4, E=4 (one expert a rank; data=1): output, aux and gradients
    against ofasys_tpu's moe_ffn_sharded on the same mesh."""
    x, rw, w1, w2, g = _moe_inputs(1, 64, 8, 16, 4)
    mesh = _jmesh(dict(data=1, expert=4))

    def jloss(*a):
        out, aux = jmoe_sharded(*a, mesh, capacity_factor=4.0)
        return (out * g).sum() + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (x, rw, w1, w2)))
    got = world.run(R.moe_sharded, x, rw, w1, w2, dict(data=1, expert=4), 4.0, g)[0]
    np.testing.assert_allclose(got["out"], np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["aux"], float(jaux), rtol=1e-5)
    for key, b in zip(("gx", "grw", "g1", "g2"), jg):
        np.testing.assert_allclose(got[key], np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pcfg", [dict(data=2, expert=2), dict(data=1, expert=4)])
def test_moe_sharded_several_experts_a_rank_matches_dense(world, pcfg):
    """E = 8 over expert=2 and 4 (4 and 2 experts a rank), no token dropped:
    the output equals the dense path's, and so do the experts' gradients (the
    aux term, which averages per-rank statistics, reaches only the router
    and the tokens)."""
    x, rw, w1, w2, g = _moe_inputs(2, 64, 8, 16, 8)
    ep = pcfg["expert"]
    got = world.run(R.moe_sharded, x, rw, w1, w2, pcfg, 64.0, g)[0]
    ts = [torch.tensor(a, requires_grad=True) for a in (x, rw, w1, w2)]
    out, aux = moe_ffn_dense(*ts, capacity_factor=64.0 / ep)
    ref = torch.autograd.grad((out * torch.as_tensor(g)).sum(), ts)
    np.testing.assert_allclose(got["out"], out.detach().numpy(), rtol=1e-5, atol=1e-6)
    for key, r in zip(("g1", "g2"), (ref[2], ref[3])):
        np.testing.assert_allclose(got[key], r.numpy(), rtol=1e-4, atol=1e-5)


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4)], rng


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_attention_matches_jax(world, use_flash):
    """sequence=4, non-causal: the output against ofasys_tpu's ring and
    against full attention."""
    (q, k, v, _), _ = _qkv(3, 1, 128, 2, 32)
    out = world.run(R.ring, q, k, v, dict(data=1, sequence=4), 0.2, use_flash)[0]["out"]
    jm = _jmesh(dict(data=1, sequence=4))
    jout = jax.jit(lambda q, k, v: jring(q, k, v, jm, scale=0.2, use_flash=use_flash))(
        *map(jnp.asarray, (q, k, v)))
    ref = dot_product_attention(*map(jnp.asarray, (q, k, v)), scale=0.2)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=RING_RTOL, atol=RING_ATOL)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RING_RTOL, atol=RING_ATOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_bias_mask_gradients(world, use_flash, causal):
    """Bias rows sharded with the queries, the keep-mask whole, causal or
    not: output and the gradients of q, k, v and the bias against
    ``jax.grad`` through ofasys_tpu's ring_attention (sequence=4)."""
    (q, k, v, g), rng = _qkv(6, 2, 64, 2, 16)
    # the flash kernels take their bias in bf16: values exact in bf16, so
    # that both sides add the same bias
    bias = torch.tensor(rng.standard_normal((1, 2, 64, 64)) * 0.5, dtype=torch.bfloat16).float().numpy()
    keep = rng.random((2, 64)) > 0.2
    keep[:, 0] = True
    mask = keep[:, None, None, :]
    got = world.run(R.ring, q, k, v, dict(data=1, sequence=4), 0.2, use_flash, causal, bias, mask, g)[0]
    jm = _jmesh(dict(data=1, sequence=4))

    def jfwd(q, k, v, b):
        return jring(q, k, v, jm, scale=0.2, use_flash=use_flash, causal=causal, bias=b,
                     mask=jnp.asarray(mask))

    jout, vjp = jax.jit(lambda *a: jax.vjp(jfwd, *a))(*map(jnp.asarray, (q, k, v, bias)))
    jgrads = jax.jit(vjp)(jnp.asarray(g))
    np.testing.assert_allclose(got["out"], np.asarray(jout), rtol=RING_RTOL, atol=RING_ATOL)
    m = np.logical_and(mask, np.asarray(jcausal_mask(64, 64))) if causal else mask
    ref = dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias), mask=jnp.asarray(m),
                                scale=0.2)
    np.testing.assert_allclose(got["out"], np.asarray(ref), rtol=RING_RTOL, atol=RING_ATOL)
    for i, (a, b) in enumerate(zip(got["grads"], jgrads)):
        # the flash kernels return a bf16 bias's gradient in bf16: that
        # rounding (at most 2**-8 of the value) on top of the tolerance
        rtol = GRAD_RTOL + (BF16_ROUNDING if use_flash and i == 3 else 0.0)
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=GRAD_ATOL)


def _moe_cfg():
    return {"dropout": 0.0, "moe_experts": 4, "moe_every_n": 2, "moe_capacity_factor": 4.0}


def test_moe_model_expert_parallel_step_matches_jax(world):
    """The tiny model with MoE in every second layer: one Adam update
    sharded over expert=4 (data=1) against ofasys_tpu's sharded step on the
    same mesh, and the port's dense step where no token is dropped."""
    from ofasys_tpu import GeneralistModel as JModel
    from ofasys_tpu.configure.configs import OptimizationConfig as JOpt
    from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
        LabelSmoothedCrossEntropyCriterion as JCrit,
        LabelSmoothedCrossEntropyCriterionConfig as JCritCfg,
    )
    from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
    from ofasys_tpu.engine.train_step import TrainState, make_train_step
    from ofasys_tpu.parallel import make_sharded_train_step, put_batch, shard_tree
    from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
    from ofasys_tpu.utils.pytree import SlotBatch as JSlot
    from ofasys_tpu import ModalityType as JMT

    jd = JDictionary()
    for i in range(60):
        jd.add_symbol(f"<text>_{i}")
    jd.pad_to_multiple_(8)
    mesh = _jmesh(dict(data=1, expert=4))
    jm = JModel(arch="tiny")
    jm.cfg.encoder.layers = jm.cfg.decoder.layers = 2
    for k, v in _moe_cfg().items():
        setattr(jm.cfg, k, v)
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32, mesh=mesh)
    arrays = R.copy_arrays(B=8, T=9)
    toks, prev, target = arrays
    batch = {"net_input": {"slots": [JSlot(JMT.TEXT, True, {"inputs": jnp.asarray(toks)}, "src"),
                                     JSlot(JMT.TEXT, False, {"inputs": jnp.asarray(prev)}, "tgt")]},
             "target": jnp.asarray(target)}
    # the port's seeded init: the tree ofasys_tpu's init makes, leaf for leaf
    params = jax.tree.map(jnp.asarray, R.init_tree(_moe_cfg()))
    crit = JCrit(JCritCfg(label_smoothing=0.1), pad_id=jd.pad())
    opt = jbuild_optimizer(JOpt(lr=(1e-2,), optimizer="sgd", lr_scheduler="fixed", clip_norm=0.0),
                           total_num_update=10)
    state = shard_tree(TrainState.create(params, opt), mesh)
    step = make_sharded_train_step(make_train_step(jm, crit, opt), mesh, state, batch, donate=False)
    s1, m1 = step(state, put_batch(batch, mesh), jax.random.PRNGKey(7))
    tree = jax.device_get(params)
    got = world.run(R.sharded_steps, tree, dict(data=1, expert=4), _moe_cfg(), arrays)[0]
    np.testing.assert_allclose(got["losses"][0], float(m1["loss"]), rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(s1.params))[0]
    for path, ref in flat:
        node = got["params"]
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(ref), rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(p.key for p in path))
    assert got["losses"][0] == pytest.approx(float(m1["loss"]), rel=1e-4)
