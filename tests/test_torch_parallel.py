"""The port's mesh, data/FSDP/tensor-parallel steps, sequence parallelism,
sharded serving and sharded checkpoints against its one-process path and
ofasys_tpu (tests/test_parallel.py, test_sharded_decode.py and
test_sharded_checkpoint.py; their sizes and tolerances).

The JAX side runs in this process on the pytest run's eight virtual CPU devices.
The port's ranks are a world of four spawned gloo processes (started once
for the file) that run tests/torch_parallel_ranks.py and import neither jax
nor ofasys_tpu; the one-process port runs in this process.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JMT
from ofasys_tpu.configure.configs import OptimizationConfig as JOpt, ParallelConfig as JParallelConfig
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCrit,
    LabelSmoothedCrossEntropyCriterionConfig as JCritCfg,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.engine.train_step import TrainState as JTrainState, make_train_step as jmake_train_step
from ofasys_tpu.parallel import build_mesh as jbuild_mesh, make_sharded_train_step as jmake_sharded
from ofasys_tpu.parallel import put_batch as jput_batch, shard_tree as jshard_tree
from ofasys_tpu.parallel import tree_shardings as jtree_shardings
from ofasys_tpu.parallel.mesh import resolve_axis_sizes as jresolve
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlot
from ofasys_torch import GeneralistModel
from ofasys_torch.configure.configs import ParallelConfig
from ofasys_torch.parallel import tree_shardings
from ofasys_torch.parallel.distributed import World
from ofasys_torch.parallel.mesh import MESH_AXES, Mesh, resolve_axis_sizes

import torch_parallel_ranks as R

LOSS_RTOL = 1e-5                          # tests/test_parallel.py:66-69
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
SP_LOSS_RTOL = 1e-4                       # its sequence-parallel test
SP_RTOL, SP_ATOL = 1e-3, 1e-5


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


def _jdict():
    d = JDictionary()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _jbatch(arrays):
    toks, prev, target = arrays
    return {"net_input": {"slots": [JSlot(JMT.TEXT, True, {"inputs": jnp.asarray(toks)}, "src"),
                                    JSlot(JMT.TEXT, False, {"inputs": jnp.asarray(prev)}, "tgt")]},
            "target": jnp.asarray(target)}


def _jmodel(mesh=None, **cfg):
    d = _jdict()
    m = JModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 2
    m.cfg.dropout = 0.0
    for k, v in cfg.items():
        setattr(m.cfg, k, v)
    m.initialize(d, active_adaptors=("text",), dtype=jnp.float32, mesh=mesh)
    return m, d


def _jstep(m, d, params, batch, mesh=None):
    crit = JCrit(JCritCfg(label_smoothing=0.1), pad_id=d.pad())
    opt = jbuild_optimizer(JOpt(lr=(1e-2,), optimizer="sgd", lr_scheduler="fixed", clip_norm=0.0),
                           total_num_update=10)
    step = jmake_train_step(m, crit, opt)
    state = JTrainState.create(params, opt)
    if mesh is None:
        return jax.jit(step)(state, batch, jax.random.PRNGKey(7))
    state = jshard_tree(state, mesh)
    sharded = jmake_sharded(step, mesh, state, batch, donate=False)
    return sharded(state, jput_batch(batch, mesh), jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def ref():
    """ofasys_tpu's one-device step on the copy batch (B=8, T=8) and the
    port's one-process step from the same weights (the port's seeded init,
    the tree ofasys_tpu's init makes, leaf for leaf)."""
    arrays = R.copy_arrays(B=8, T=8)
    m, d = _jmodel()
    tree = R.init_tree({"dropout": 0.0})
    params = jax.tree.map(jnp.asarray, tree)
    s1, m1 = _jstep(m, d, params, _jbatch(arrays))
    port = R.sharded_steps(tree, None, {"dropout": 0.0}, arrays)
    return dict(arrays=arrays, tree=tree, jparams=jax.device_get(s1.params), jloss=float(m1["loss"]),
                port=port, jm=m, jd=d, params=params)


# key-side biases add the same amount to every score of a softmax row:
# their gradient is 0 in exact arithmetic and rounding noise in practice
# (tests/test_torch_train_step.py); across the two packages an SGD step of
# lr 1e-2 moves them by the noise, held to NOISE_ATOL
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")
NOISE_ATOL = 1e-5
ADAM_MEAN_ATOL = 2e-6                     # tests/test_torch_train_step.py


def _assert_adam_trees(got, want, lr, n_steps):
    """Parameters after Adam updates, as tests/test_torch_train_step.py
    holds them: Adam's m/sqrt(v) turns a gradient entry near 0 into a step
    of up to lr whatever its size, so two runs whose gradients part by
    rounding may part by up to 2 lr an update at such entries; each leaf's
    mean |difference| stays under PARAM_MEAN_ATOL."""
    for path, b in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        diff = np.abs(np.asarray(node) - np.asarray(b))
        keys = [p.key for p in path]
        name = "/".join(keys)
        assert diff.max() <= 2 * lr * n_steps, name
        if not (keys[-1] == "bias" and keys[-2] in NOISE_MODULES):   # per-entry bound only
            assert diff.mean() <= ADAM_MEAN_ATOL, name


def _assert_trees(got, want, rtol, atol, noise=False):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert flat
    for path, b in flat:
        node = got
        for p in path:
            node = node[p.key]
        keys = [p.key for p in path]
        quiet = noise and keys[-1] == "bias" and keys[-2] in NOISE_MODULES
        np.testing.assert_allclose(np.asarray(node), np.asarray(b), rtol=0.0 if quiet else rtol,
                                   atol=NOISE_ATOL if quiet else atol, err_msg="/".join(keys))


@pytest.mark.parametrize("cfg,n", [
    (dict(), 8), (dict(data=2, fsdp=2, tensor=2), 8), (dict(data=-1, tensor=2), 8),
    (dict(data=-1, pipeline=2), 8), (dict(data=3), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(data=-1, fsdp=3), 8), (dict(data=2, tensor=2), 2),
])
def test_resolve_axis_sizes(cfg, n):
    """The port's copy of resolve_axis_sizes: the same sizes, the same errors."""
    try:
        want = jresolve(JParallelConfig(**cfg), n)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            resolve_axis_sizes(ParallelConfig(**cfg), n)
        assert str(err.value) == str(e)
        return
    assert resolve_axis_sizes(ParallelConfig(**cfg), n) == want


def test_mesh_axes(world):
    """Ranks lie row-major over MESH_AXES; every axis has its group."""
    out = world.run(R.mesh_shape, dict(data=1, fsdp=2, tensor=2))
    assert out[0]["shape"] == {"data": 1, "fsdp": 2, "tensor": 2, "sequence": 1, "expert": 1, "pipe": 1}
    assert [(o["coords"]["fsdp"], o["coords"]["tensor"]) for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {o["backend"] for o in out} == {"gloo"}


def test_param_sharding_rules_applied(ref):
    """DEFAULT_RULES, rank trimming and 'does not divide -> replicated' give
    ofasys_tpu's spec for every leaf of its tree (data=1, fsdp=4, tensor=2)."""
    jmesh = jbuild_mesh(JParallelConfig(data=1, fsdp=4, tensor=2))
    want = jtree_shardings(ref["params"], jmesh)
    mesh = Mesh(dict(zip(MESH_AXES, (1, 4, 2, 1, 1, 1))), {a: 0 for a in MESH_AXES},
                {a: None for a in MESH_AXES}, "cpu", None)
    got = tree_shardings(ref["tree"], mesh)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, sh in flat:
        node = got
        for p in path:
            node = node[p.key]
        assert node == tuple(sh.spec) + (None,) * (len(node) - len(tuple(sh.spec))), path


@pytest.mark.parametrize("pcfg", [dict(data=4), dict(data=1, fsdp=2, tensor=2), dict(data=2, tensor=2)])
def test_sharded_train_matches_single_device(world, ref, pcfg):
    """One SGD update sharded over four ranks equals the one-process update
    (the JAX test's tolerances) and ofasys_tpu's; at data=2 x tensor=2 also
    ofasys_tpu's sharded step."""
    got = world.run(R.sharded_steps, ref["tree"], pcfg, {"dropout": 0.0}, ref["arrays"])[0]
    np.testing.assert_allclose(got["losses"][0], ref["port"]["losses"][0], rtol=LOSS_RTOL)
    _assert_trees(got["params"], ref["port"]["params"], PARAM_RTOL, PARAM_ATOL)
    np.testing.assert_allclose(got["losses"][0], ref["jloss"], rtol=SP_LOSS_RTOL)
    _assert_trees(got["params"], ref["jparams"], PARAM_RTOL, PARAM_ATOL, noise=True)
    if pcfg == dict(data=2, tensor=2):
        jmesh = jbuild_mesh(JParallelConfig(**pcfg), devices=jax.devices()[:4])
        s1, m1 = _jstep(ref["jm"], ref["jd"], ref["params"], _jbatch(ref["arrays"]), jmesh)
        np.testing.assert_allclose(got["losses"][0], float(m1["loss"]), rtol=SP_LOSS_RTOL)
        _assert_trees(got["params"], jax.device_get(s1.params), PARAM_RTOL, PARAM_ATOL, noise=True)


@pytest.mark.parametrize("pcfg,zero1", [(dict(data=4), True), (dict(data=1, fsdp=4), False)])
def test_sliced_optimizer_matches_single_device(world, ref, pcfg, zero1):
    """Adam with clipping, two updates: the optimizer state sliced over the
    data axis (zero1) or over fsdp equals the one-process run."""
    opt = dict(lr=(1e-3,), optimizer="adam", lr_scheduler="fixed", clip_norm=0.5)
    want = R.sharded_steps(ref["tree"], None, {"dropout": 0.0}, ref["arrays"], opt_kw=opt, n_steps=2)
    got = world.run(R.sharded_steps, ref["tree"], pcfg, {"dropout": 0.0}, ref["arrays"], opt_kw=opt,
                    n_steps=2, zero1=zero1)[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _assert_adam_trees(got["params"], want["params"], 1e-3, 2)
    if zero1:           # every rank keeps the whole parameters
        assert got["param_bytes"] == want["param_bytes"]
    else:               # fsdp holds only its slices (the kernels and tables, a quarter each)
        assert got["param_bytes"] < want["param_bytes"] / 2


@pytest.mark.parametrize("pcfg,cfg_kw", [
    (dict(data=1, fsdp=2, tensor=2), {"ln_impl": "pallas", "scale_fc": True}),
    (dict(data=1, fsdp=4), {"remat": "full"}),
])
def test_sharded_options_match_single_device(world, pcfg, cfg_kw):
    """One SGD update under options that change what a shard runs equals
    the one-process update with the same options: the FFN's mid LayerNorm
    through B6's plain version on the gathered rows under tensor
    parallelism, and the fsdp layers gathering their slices again in
    remat's recompute."""
    arrays = R.copy_arrays(B=8, T=8)
    tree = R.init_tree({"dropout": 0.0, **cfg_kw})
    want = R.sharded_steps(tree, None, {"dropout": 0.0, **cfg_kw}, arrays)
    got = world.run(R.sharded_steps, tree, pcfg, {"dropout": 0.0, **cfg_kw}, arrays)[0]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=LOSS_RTOL)
    _assert_trees(got["params"], want["params"], PARAM_RTOL, PARAM_ATOL)
    assert got["param_bytes"] < want["param_bytes"] / 2


@pytest.mark.parametrize("env,world,cards,backend", [
    ({"LOCAL_WORLD_SIZE": "8"}, 16, 8, "nccl"),      # two nodes of eight ranks, a card each
    ({}, 2, 1, "gloo"),                              # two ranks on one card
    ({"LOCAL_WORLD_SIZE": "2"}, 4, 1, "gloo"),
])
def test_distributed_init_backend(monkeypatch, env, world, cards, backend):
    """distributed_init picks NCCL where every rank of a node has a card
    (torchrun's LOCAL_WORLD_SIZE against the node's cards), gloo otherwise."""
    import torch.distributed as dist

    from ofasys_torch.parallel import distributed as PD

    for k in ("OFASYS_COORDINATOR", "OFASYS_NUM_PROCESSES", "OFASYS_PROCESS_ID", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    seen = {}
    monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: seen.update(backend=b, **kw))
    assert PD.distributed_init() == (1, world)
    assert seen["backend"] == backend and seen["world_size"] == world


@pytest.mark.parametrize("pcfg", [dict(data=2, sequence=2), dict(data=1, sequence=4)])
def test_sequence_parallel_model_matches_dense(world, ref, pcfg):
    """cfg.sequence_parallel: every training self-attention runs the ring
    (enc and dec T = 8); one update equals ofasys_tpu's dense one-device
    update at its sequence-parallel test's tolerances."""
    got = world.run(R.sharded_steps, ref["tree"], pcfg, {"dropout": 0.0, "sequence_parallel": True},
                    ref["arrays"])[0]
    np.testing.assert_allclose(got["losses"][0], ref["jloss"], rtol=SP_LOSS_RTOL)
    _assert_trees(got["params"], ref["jparams"], SP_RTOL, SP_ATOL, noise=True)
    np.testing.assert_allclose(got["losses"][0], ref["port"]["losses"][0], rtol=LOSS_RTOL)


def test_sequence_parallel_guards():
    """pipeline + sequence_parallel is refused at initialize() with
    ofasys_tpu's error; an indivisible length under sequence_parallel warns
    and falls back to dense attention."""
    for cls in (JModel, GeneralistModel):
        m = cls(arch="tiny")
        m.cfg.scan_layers = True
        m.cfg.pipeline_stages = 2
        m.cfg.sequence_parallel = True
        with pytest.raises(ValueError, match="sequence_parallel cannot be combined"):
            m.initialize((_jdict if cls is JModel else R.dictionary)(), active_adaptors=("text",),
                         **({} if cls is JModel else {"device": "cpu"}))
    mesh = Mesh(dict(zip(MESH_AXES, (1, 1, 1, 4, 1, 1))), {a: 0 for a in MESH_AXES},
                {a: None for a in MESH_AXES}, "cpu", None)
    m = R.build({"dropout": 0.0, "sequence_parallel": True}, mesh=mesh, layers=1)
    toks, prev, target = R.copy_arrays(B=4, T=8)
    s = R.sample(toks[:, :6], prev[:, :7], target[:, :7])     # enc T = 6, dec T = 7
    from ofasys_torch.utils.pytree import sample_to_device

    s = sample_to_device(s, "cpu")
    with pytest.warns(UserWarning, match="falling back to DENSE"):
        m.apply_train(s["net_input"]["slots"], deterministic=True)


@pytest.mark.parametrize("dtype,int8,pcfg", [
    ("float32", False, dict(data=1, tensor=4)),
    ("bfloat16", False, dict(data=1, tensor=2, fsdp=2)),
    ("float32", True, dict(data=1, tensor=4)),
])
def test_hub_shard_tokens_match_one_rank(world, dtype, int8, pcfg):
    """OFASys.shard: beam search on the tensor-parallel hub (the vocab
    rows split too; after quantize() for int8: B7's plain version on the
    local int8 shards) gives one-rank serving's tokens and scores (in bf16
    and w8a8 but where the searches part at a near-tie)."""
    recs = [{"src": "a b c d"}, {"src": "e f"}, {"src": "g h i"}, {"src": "j k l m n"}]
    gen = dict(beam_size=2, max_len_b=8, min_len=1)
    want = R.hub_tokens(None, dtype, int8, recs, gen)
    got = world.run(R.hub_tokens, pcfg, dtype, int8, recs, gen)[0]
    # in fp32 every answer is the one-rank answer; in bf16 and under w8a8 a
    # shard's product rounds apart from the whole one by an ulp, and a beam
    # selection kept by less than a near-tie can go the other way
    # (chip_smoke's SHARD_TIE_TOL): such a request may part there, and only there
    import chip_smoke

    tol = 0.0 if dtype == "float32" and not int8 else chip_smoke.SHARD_TIE_TOL
    same = []
    for row, ((a, sa), (b, sb)) in enumerate(zip(got["answers"], want["answers"], strict=True)):
        if a == b:
            same.append((sa, sb))
        else:
            assert chip_smoke._parting_margin(got["log"], want["log"], row) <= tol, (row, a, b)
    assert same
    # scores of equal answers: the JAX test's 1e-4 in fp32; a bf16 step in
    # bf16; under w8a8 an fp32 rounding of an activation can move one int8
    # step and shift later logits (the README's int8 notes), so 1e-2 there
    rtol = 2.0 ** -7 if dtype == "bfloat16" else (1e-2 if int8 else 1e-4)
    np.testing.assert_allclose([a for a, _ in same], [b for _, b in same], rtol=rtol, atol=1e-5)


def test_sharded_checkpoint_restores_on_another_layout(world, ref, tmp_path):
    """Adam updates saved as a sharded checkpoint on data=1 x fsdp=2 x
    tensor=2 (each rank writes only its pieces) restore on data=2 x
    tensor=2, on data=4 and in one process and go on as the uninterrupted
    run; the directory reads back whole for one process (OFASys.from_pretrained's
    load_checkpoint)."""
    root = str(tmp_path)
    want = R.checkpoint_steps(ref["tree"], None, ref["arrays"], root, None, None, 2)
    a = world.run(R.checkpoint_steps, ref["tree"], dict(data=1, fsdp=2, tensor=2), ref["arrays"], root,
                  "ck", None, 1)[0]
    assert a["losses"][0] == pytest.approx(want["losses"][0], rel=LOSS_RTOL)
    import os

    shards = sorted(f for f in os.listdir(os.path.join(root, "ck")) if f.startswith("shard_"))
    assert len(shards) == 4
    for pcfg in (dict(data=2, tensor=2), dict(data=4)):
        b = world.run(R.checkpoint_steps, ref["tree"], pcfg, ref["arrays"], root, None, "ck", 1)[0]
        assert b["step"] == 2
        np.testing.assert_allclose(b["losses"][0], want["losses"][1], rtol=LOSS_RTOL)
        _assert_adam_trees(b["params"], want["params"], 1e-3, 2)
    c = R.checkpoint_steps(ref["tree"], None, ref["arrays"], root, None, "ck", 1)
    np.testing.assert_allclose(c["losses"][0], want["losses"][1], rtol=LOSS_RTOL)
    # the whole tree of the directory, as OFASys.from_pretrained reads it
    from ofasys_torch.utils import checkpoint_utils as tcu

    tree, meta = tcu.load_checkpoint(os.path.join(root, "ck"))
    assert tree["step"] == 1 and meta["num_updates"] == 1
    _assert_trees({k: v for k, v in tree["params"].items()},
                  jax.tree.map(np.asarray, a["params"]), 0.0, 0.0)
