"""The port's remat, stacked parameter layout and layer-layout guards
against ofasys_tpu (tests/test_scan_remat.py's sizes and tolerances).

remat changes memory, not values: with dropout on and the same step
generator, the port's 'full' and 'dots' modes give the outputs and
gradients of 'none' bit for bit (the generator's state is replayed in the
recompute). ``scan_layers`` keeps one module a layer and reads and writes
ofasys_tpu's stacked tree (``layers_scan/layer/<leaf>``, a leading layer
axis), int8 serving kernels included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, ModalityType as JMT
from ofasys_tpu.generator import SequenceGenerator as JGenerator
from ofasys_tpu.ops.quant import quantize_for_serving as jquantize
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.utils.pytree import SlotBatch as JSlot
from ofasys_torch import GeneralistModel, ModalityType
from ofasys_torch.engine.train_step import dropout_generator
from ofasys_torch.generator import SequenceGenerator
from ofasys_torch.ops.quant import quantize_for_serving
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils.jax_params import export_params, load_jax_params, stack_layers, unstack_layers
from ofasys_torch.utils.pytree import SlotBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dict(cls, n=80):
    d = cls()
    for i in range(n):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _arrays(d, B=2, Ts=10, Tt=6, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(d.nspecial, d.nspecial + 60, size=(B, Ts)).astype(np.int32)
    tgt = r.integers(d.nspecial, d.nspecial + 60, size=(B, Tt)).astype(np.int32)
    prev = np.concatenate([np.full((B, 1), d.bos(), np.int32), tgt[:, :-1]], 1)
    return toks, prev, tgt


def _jslots(toks, prev):
    return [JSlot(JMT.TEXT, True, {"inputs": jnp.asarray(toks)}, "src"),
            JSlot(JMT.TEXT, False, {"inputs": jnp.asarray(prev)}, "tgt")]


def _tslots(toks, prev):
    return [SlotBatch(ModalityType.TEXT, True, {"inputs": torch.as_tensor(toks, dtype=torch.long)}, "src"),
            SlotBatch(ModalityType.TEXT, False, {"inputs": torch.as_tensor(prev, dtype=torch.long)}, "tgt")]


def _jmodel(d, scan=False, remat="none", layers=3):
    m = JModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = layers
    m.cfg.dropout = 0.0
    m.cfg.scan_layers = scan
    m.cfg.remat = remat
    m.initialize(d, active_adaptors=("text",), dtype=jnp.float32)
    return m


def _tmodel(d, layers=3, **cfg):
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = layers
    m.cfg.dropout = 0.0
    for k, v in cfg.items():
        setattr(m.cfg, k, v)
    m.initialize(d, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    return m


@pytest.fixture(scope="module")
def loop():
    """ofasys_tpu's loop-layout init (3+3 layers) and its logits."""
    d = _dict(JDictionary)
    toks, prev, tgt = _arrays(d)
    m = _jmodel(d)
    params = m.init_params(jax.random.PRNGKey(0), _jslots(toks, prev))
    logits, _ = jax.jit(lambda p: m.apply(p, _jslots(toks, prev)))(params)
    return dict(tree=jax.device_get(params), logits=np.asarray(logits), arrays=(toks, prev, tgt), jm=m,
                params=params)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_equals_plain(loop, mode):
    """Training-mode outputs and gradients (dropout 0.1, one step
    generator) equal remat='none' bit for bit; the deterministic logits
    equal ofasys_tpu's remat model's."""
    toks, prev, tgt = loop["arrays"]
    td = _dict(Dictionary)
    outs = []
    for remat in ("none", mode):
        m = _tmodel(td, remat=remat, dropout=0.1)
        load_jax_params(m.net, loop["tree"])
        gen = dropout_generator(0, 3, 0, 0, torch.device("cpu"))
        out, _ = m.apply_train(_tslots(toks, prev), generator=gen)
        loss = torch.nn.functional.cross_entropy(out.float().reshape(-1, out.shape[-1]),
                                                 torch.as_tensor(tgt, dtype=torch.long).reshape(-1))
        outs.append((out.detach(), torch.autograd.grad(loss, list(m.net.parameters()), allow_unused=True), m))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    jm = _jmodel(_dict(JDictionary), remat=mode)
    jlogits, _ = jax.jit(lambda p: jm.apply(p, _jslots(toks, prev)))(loop["params"])
    tlogits, _ = outs[1][2].apply(_tslots(toks, prev))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)


def test_unknown_remat_mode_raises():
    for cls, d in ((JModel, _dict(JDictionary)), (GeneralistModel, _dict(Dictionary))):
        m = cls(arch="tiny")
        m.cfg.remat = "some"
        with pytest.raises(ValueError, match="unknown remat mode 'some'"):
            m.initialize(d, active_adaptors=("text",), **({"device": "cpu"} if cls is GeneralistModel else {}))
            if cls is JModel:
                toks, prev, _ = _arrays(d)
                m.init_params(jax.random.PRNGKey(0), _jslots(toks, prev))


def test_scan_layers_loads_jax_stacked_params(loop):
    """ofasys_tpu's scan-layout init loads into the port's per-layer
    modules: logits equal ofasys_tpu's scan model's, and the port exports
    the same stacked tree."""
    d = _dict(JDictionary)
    toks, prev, _ = loop["arrays"]
    jm = _jmodel(d, scan=True)
    params = jm.init_params(jax.random.PRNGKey(1), _jslots(toks, prev))
    jlogits, _ = jax.jit(lambda p: jm.apply(p, _jslots(toks, prev)))(params)
    tree = jax.device_get(params)
    assert tree["encoder"]["layers_scan"]["layer"]["self_attn"]["q_proj"]["kernel"].shape[0] == 3
    tm = _tmodel(_dict(Dictionary), scan_layers=True)
    load_jax_params(tm.net, tree)
    tlogits, _ = tm.apply(_tslots(toks, prev))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    back = export_params(tm.net)
    for path, ref in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(ref))
    # the loop layout of the same weights gives the same logits
    lm = _tmodel(_dict(Dictionary))
    load_jax_params(lm.net, unstack_layers(tree))
    np.testing.assert_array_equal(lm.apply(_tslots(toks, prev))[0].numpy(), tlogits.numpy())


def test_scan_params_greedy_decode_matches_loop(loop):
    """Greedy tokens from the stacked layout equal the loop layout's with
    the same weights, and ofasys_tpu's scan model's."""
    d = _dict(JDictionary)
    toks, prev, _ = _arrays(d, B=2, Ts=8, Tt=4)
    n = 3
    jm = _jmodel(d, scan=True, layers=n)
    stacked = stack_layers(loop["tree"])
    jout = JGenerator(jm, d, beam_size=1, max_len_b=6, min_len=1).generate(
        stacked, {"net_input": {"slots": _jslots(toks, prev)}})
    outs = []
    for scan, tree in ((True, stacked), (False, loop["tree"])):
        td = _dict(Dictionary)
        tm = _tmodel(td, layers=n, scan_layers=scan)
        load_jax_params(tm.net, tree)
        outs.append(SequenceGenerator(tm, td, beam_size=1, max_len_b=6, min_len=1).generate(
            {"net_input": {"slots": _tslots(toks, prev)}}))
    for a, b, j in zip(*outs, jout):
        assert list(a[0].tokens) == list(b[0].tokens) == list(np.asarray(j[0].tokens))


def test_stacked_int8_kernels_load_per_layer(loop):
    """ofasys_tpu's int8 serving variables of a stacked tree (q (L, in,
    out), scales per layer and output channel) load into each layer's B7
    buffers: the same buffers as the port's own quantization of those
    weights, and the same int8 logits."""
    stacked = stack_layers(loop["tree"])
    jvars = jax.device_get(jquantize(stacked))
    fc1 = jvars["qkern"]["decoder"]["layers_scan"]["layer"]["ffn"]["fc1"]
    assert fc1["q"].shape[0] == 3 and fc1["scale"].shape[0] == 3
    toks, prev, _ = loop["arrays"]
    got = _tmodel(_dict(Dictionary), scan_layers=True)
    load_jax_params(got.net, jvars)
    ref = _tmodel(_dict(Dictionary))
    load_jax_params(ref.net, loop["tree"])
    quantize_for_serving(ref.net)
    for (n, a), (m, b) in zip(got.net.named_buffers(), ref.net.named_buffers()):
        assert n == m
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    np.testing.assert_array_equal(got.apply(_tslots(toks, prev))[0].numpy(),
                                  ref.apply(_tslots(toks, prev))[0].numpy())


@pytest.mark.parametrize("cfg,message", [
    (dict(pipeline_stages=2), "pipeline_stages > 1 requires scan_layers"),
    (dict(scan_layers=True, encoder__layerdrop=0.1), "layerdrop requires the loop layer layout"),
    (dict(scan_layers=True, moe_experts=4), "moe_experts requires the loop layer layout"),
    (dict(scan_layers=True, pipeline_stages=2, sequence_parallel=True), "sequence_parallel cannot be combined"),
])
def test_layout_guards_raise_like_jax(cfg, message):
    """The combinations ofasys_tpu's initialize refuses raise the same
    errors in the port."""
    for cls, d in ((JModel, _dict(JDictionary)), (GeneralistModel, _dict(Dictionary))):
        m = cls(arch="tiny")
        for k, v in cfg.items():
            if "__" in k:
                stack, field = k.split("__")
                setattr(getattr(m.cfg, stack), field, v)
            else:
                setattr(m.cfg, k, v)
        with pytest.raises(ValueError, match=message):
            m.initialize(d, active_adaptors=("text",), **({"device": "cpu"} if cls is GeneralistModel else {}))


@pytest.mark.parametrize("cfg", [dict(remat="full"), dict(remat="dots"), dict(scan_layers=True),
                                 dict(moe_experts=8), dict(pipeline_stages=2, scan_layers=True),
                                 dict(sequence_parallel=True)])
def test_each_option_initializes_and_runs(loop, cfg):
    """Each layout option initializes on its own and runs a forward (the
    mesh-less net takes the one-process path)."""
    toks, prev, _ = loop["arrays"]
    m = _tmodel(_dict(Dictionary), layers=2, **cfg)
    out, _ = m.apply(_tslots(toks, prev))
    assert torch.isfinite(out).all()
