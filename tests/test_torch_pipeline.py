"""The port's GPipe pipeline (parallel/pipeline.py) against ofasys_tpu's
and against the sequential stack (tests/test_pipeline.py's sizes and
tolerances), and two-rank Trainer fits: pipeline=2, and data=2 with its
sharded checkpoint served by ``OFASys.from_pretrained``.

The JAX side runs in this process on the pytest run's eight virtual CPU devices;
the port's ranks are a world of two spawned gloo processes (started once
for the file) that run tests/torch_parallel_ranks.py and import neither jax
nor ofasys_tpu.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JMT
from ofasys_tpu.parallel.pipeline import pipeline_stack as jpipeline_stack
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlot
from ofasys_torch.parallel.distributed import World

import torch_parallel_ranks as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with World(2) as w:
        yield w


def _jpipe_mesh(pipe: int) -> JMesh:
    devs = np.asarray(jax.devices()[:pipe])
    return JMesh(devs.reshape(1, 1, 1, 1, 1, pipe), ("data", "fsdp", "tensor", "sequence", "expert", "pipe"))


def test_pipeline_stack_matches_jax(world):
    """The toy stack of ofasys_tpu's test (L=8, B=16, T=8, E=32, 4
    microbatches) over 2 stages: output and gradients against ofasys_tpu's
    pipeline_stack and the sequential loop."""
    L, B, T, E = 8, 16, 8, 32
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, E, E)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((L, E)) * 0.05).astype(np.float32)
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    scale = np.float32(1.01)
    got = world.run(R.pipeline_toy, w, b, x, mask, scale, dict(data=1, pipeline=2), 4)[0]
    seq = R.pipeline_toy(w, b, x, mask, scale, None, 4)
    mesh = _jpipe_mesh(2)

    def layer_apply(lp, gi, m, x_mb, mm, bcast):
        return jnp.tanh(x_mb @ lp["w"] + lp["b"]) * mm[:, :, None] * bcast + x_mb

    def piped(params, x):
        return jpipeline_stack(mesh, layer_apply, params, x, micro_args=jnp.asarray(mask),
                               bcast_args=jnp.float32(scale), n_micro=4)

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    y_ref = jax.jit(piped)(params, jnp.asarray(x))
    g_ref = jax.jit(jax.grad(lambda p, x: jnp.sum(piped(p, x) ** 2), argnums=(0, 1)))(params, jnp.asarray(x))
    for out in (got, seq):
        np.testing.assert_allclose(out["y"], np.asarray(y_ref), rtol=1e-5, atol=1e-6)
        for key, ref in (("gw", g_ref[0]["w"]), ("gb", g_ref[0]["b"]), ("gx", g_ref[1])):
            np.testing.assert_allclose(out[key], np.asarray(ref), rtol=2e-3, atol=1e-4)


def test_model_pipeline_matches_scan(world):
    """The tiny model (4+4 layers, stacked layout) pipelined over pipe=2:
    logits and the gradients of the mean NLL against the sequential port
    and ofasys_tpu's scan-over-layers model on the same parameters."""
    d = JDictionary()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    jm = JModel(arch="tiny")
    jm.cfg.dropout = 0.0
    jm.cfg.scan_layers = True
    jm.initialize(d, active_adaptors=("text",), dtype=jnp.float32)
    toks, prev, target = R.copy_arrays(B=8, T=8)
    slots = [JSlot(JMT.TEXT, True, {"inputs": jnp.asarray(toks)}, "src"),
             JSlot(JMT.TEXT, False, {"inputs": jnp.asarray(prev)}, "tgt")]
    # the port's seeded init (stacked): the tree ofasys_tpu's init makes, leaf for leaf
    params = jax.tree.map(jnp.asarray, R.init_tree({"dropout": 0.0, "scan_layers": True}, layers=4))
    tgt = jnp.asarray(target)

    def loss(p):
        lg, _ = jm.net.apply({"params": p}, slots, True)
        lp = jax.nn.log_softmax(lg.astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(lp, tgt[..., None], axis=-1)), lg

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tree = jax.device_get(params)
    got = world.run(R.pipeline_model_grads, tree, dict(data=1, pipeline=2), (toks, prev, target))[0]
    seq = R.pipeline_model_grads(tree, None, (toks, prev, target))
    from ofasys_torch.utils.jax_params import unstack_layers

    jg = jax.tree.map(np.asarray, unstack_layers(jax.device_get(jgrads)))
    for out in (got, seq):
        np.testing.assert_allclose(out["logits"], np.asarray(jlogits), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["loss"], float(jloss), rtol=1e-5)
        for path, ref in jax.tree_util.tree_flatten_with_path(jg)[0]:
            node = out["grads"]
            for p in path:
                node = node[p.key]
            np.testing.assert_allclose(node, ref, rtol=5e-3, atol=5e-4,
                                       err_msg="/".join(p.key for p in path))


def test_trainer_fit_with_pipeline(world):
    """cfg.parallel.pipeline=2 over two ranks: the Trainer builds the pipe
    mesh, turns the model to the stacked layout with two stages, and both
    stages end with the same replicated parameters."""
    out = world.run(R.fit, None, dict(data=1, pipeline=2), 6)
    for o in out:
        assert o["step"] == 6 and o["shape"]["pipe"] == 2 and o["stacked"] == (2, True)
        assert np.isfinite(o["loss"])
    for a, b in zip(jax.tree.leaves(out[0]["params"]), jax.tree.leaves(out[1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_two_rank_fit_data_parallel_and_sharded_checkpoint(world, tmp_path):
    """Trainer.fit at data=2 (each rank reads its half of the data): the
    ranks' parameters stay equal, the sharded checkpoint holds each piece
    once, and OFASys.from_pretrained serves it with the trained weights."""
    from ofasys_torch import OFASys
    from ofasys_torch.utils.jax_params import export_params

    save = str(tmp_path / "ck")
    out = world.run(R.fit, save, dict(data=2), 4, 4)
    for a, b in zip(jax.tree.leaves(out[0]["params"]), jax.tree.leaves(out[1]["params"])):
        np.testing.assert_array_equal(a, b)
    last = os.path.realpath(os.path.join(save, "checkpoint_last"))
    assert os.path.isdir(last)
    # data parallelism replicates every piece: its first replica writes it
    assert sorted(f for f in os.listdir(last) if f.startswith("shard_")) == ["shard_00000.pt"]
    hub = OFASys.from_pretrained(os.path.join(save, "checkpoint_last"), device="cpu", dtype=torch.float32)
    got = export_params(hub.model.net)
    for path, ref in jax.tree_util.tree_flatten_with_path(out[0]["params"])[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, ref)
    res = hub.inference("[TEXT:src] -> [TEXT:tgt]", [{"src": "red bird sky tree"}], beam_size=2, max_len_b=4)
    assert len(res) == 1


def test_two_rank_fit_fsdp_holds_slices(world, tmp_path):
    """Trainer.fit at fsdp=2: each rank holds about half of the parameter
    bytes, the updates equal data=2's, validation (which gathers the
    slices it reads) scores as data=2's does, and OFASys.from_pretrained
    serves the sharded checkpoint with the trained weights."""
    from ofasys_torch import OFASys
    from ofasys_torch.utils.jax_params import export_params

    save = str(tmp_path / "ck")
    want = world.run(R.fit, None, dict(data=2), 4, 4, valid=True)[0]
    out = world.run(R.fit, save, dict(data=1, fsdp=2), 4, 4, valid=True)
    assert all(o["param_bytes"] < 0.6 * want["param_bytes"] for o in out)
    # Adam (lr 5e-3, 4 updates) as tests/test_torch_train_step.py holds it:
    # a gathered slice runs another GEMM order than the whole weight, and
    # m/sqrt(v) turns a rounding-level gradient entry into a step of up to
    # lr, so an entry may part by 2 lr an update; each leaf's mean
    # difference stays under 2e-6 but at the key-side biases, whose
    # gradient is rounding noise
    for path, a in jax.tree_util.tree_flatten_with_path(out[0]["params"])[0]:
        b = want["params"]
        for p in path:
            b = b[p.key]
        diff = np.abs(np.asarray(a) - np.asarray(b))
        keys = [p.key for p in path]
        assert diff.max() <= 2 * 5e-3 * 4, keys
        if not (keys[-1] == "bias" and keys[-2] in ("k_proj", "pos_k_linear", "cross_pos_k_linear")):
            assert diff.mean() <= 2e-6, keys
    assert out[0]["valid"]["loss"] == pytest.approx(want["valid"]["loss"], rel=1e-4)
    hub = OFASys.from_pretrained(os.path.join(save, "checkpoint_last"), device="cpu", dtype=torch.float32)
    got = export_params(hub.model.net)
    for path, ref in jax.tree_util.tree_flatten_with_path(out[0]["params"])[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, ref)
