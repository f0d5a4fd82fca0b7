"""ofasys_torch's training step against ofasys_tpu's, and the port's
dropout in training mode.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides,
dropout 0, ``attn_kernel='pallas'``: JAX runs the Pallas dense-attention
kernels (B1 forward, B2 backward) in interpret mode, the port their plain
versions. Every batch has B*T >= 256, so each attention call of the step
(encoder self, decoder self, cross) meets the dense gate. The batches come
from the train split with span masking; the two packages make identical
token arrays. The JAX parameters are carried into the port with
``load_jax_params``; gradients and parameters come back with
``export_params`` and are compared leaf by leaf.

Tolerances:
  * loss and gnorm: rtol 1e-4 (fp32 sums of a few thousand terms, taken in
    another order; the dense bias is rounded to bf16 on both sides, and a
    fused JAX bias sum can flip one of those roundings);
  * gradients: atol 1e-5 + rtol 1e-3 of the leaf's largest entry;
  * parameters after 3 updates (lr 1e-3): the mean |difference| of each
    leaf <= 2e-6 (0.002 lr), and every entry within 2 lr per update. Adam's
    m/sqrt(v) turns a gradient entry near 0 (a rarely used position row,
    say) into a step of up to lr whatever the gradient's size, so a tiny
    gradient difference there can move that entry by a visible part of lr;
    two runs cannot differ by more than two such steps per update. The
    key-side biases (``k_proj``, ``pos_k_linear``, ``cross_pos_k_linear``)
    add the same amount to every score of a softmax row: their gradient is
    0 in exact arithmetic and rounding noise in practice, so Adam moves
    them by the noise's sign; they are held to the per-entry bound only.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.engine import train_step as jts
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
from ofasys_torch.model.transformer import drop_path
from ofasys_torch.ops import attention as tattn
from ofasys_torch.ops import dense_attention as tdense
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device

INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
PARAM_MEAN_ATOL = 2e-6
LR = 1e-3
N_UPDATES = 3
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


def _configure(m, dropout=0.0):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = dropout
    c.attn_kernel = "pallas"


def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _perturb(params, seed=0):
    """Random values for tables and biases, so every parameter matters."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "rel_pos_table":
            return 0.3 * noise
        if name in ("bias", "type_embedding"):
            return a + 0.05 * noise
        if name == "scale":
            return a + 0.1 * noise
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def _words(rng, n_chars):
    words = ["the", "model", "learns", "to", "fill", "in", "masked", "spans", "of", "text",
             "and", "to", "summarize", "a", "short", "article", "about", "the", "weather"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _records(seed):
    rng = np.random.default_rng(seed)
    infill = [{"text": _words(rng, int(rng.integers(40, 56)))} for _ in range(8)]
    summary = [{"src": _words(rng, int(rng.integers(60, 90))),
                "tgt": _words(rng, int(rng.integers(34, 44)))} for _ in range(8)]
    return infill, summary


def _pad_to(sample, shapes, pad):
    """Pad the slot inputs and the target of a collated sample to ``shapes``
    (so microbatches can be stacked for JAX's update_freq axis)."""
    out = copy.copy(sample)
    slots = []
    for s, T in zip(sample["net_input"]["slots"], shapes["slots"]):
        a = np.asarray(s.value["inputs"])
        v = dict(s.value, inputs=np.pad(a, ((0, 0), (0, T - a.shape[1])), constant_values=pad))
        slots.append(type(s)(**{**s.__dict__, "value": v}))
    out["net_input"] = {"slots": slots}
    t = sample["target"]
    out["target"] = np.pad(t, ((0, 0), (0, shapes["target"] - t.shape[1])), constant_values=pad)
    return out


@pytest.fixture(scope="module")
def setup():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _configure(jm)
    jgp = JGeneralPreprocess(jd, active=["text"])
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _configure(tm)
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    assert len(jd) == len(td) and jd.pad() == td.pad()

    # batches: two of each task, made in the same order on both sides (the
    # span-masking rng advances per record)
    jbatches, tbatches = {}, {}
    for i in range(2):
        infill, summary = _records(seed=10 + i)
        for name, tpl, recs in (("infill", INFILL, infill), ("summary", SUMMARY, summary)):
            js = jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in recs])
            ts = tgp.collate([tgp(Instruction(tpl, split="train").format(**r)) for r in recs])
            jbatches.setdefault(name, []).append(js)
            tbatches.setdefault(name, []).append(ts)
    params = _perturb(jm.init_params(jax.random.PRNGKey(0), jbatches["summary"][0]["net_input"]["slots"]))
    return dict(jm=jm, td=td, tm=tm, params=params, jb=jbatches, tb=tbatches, pad=td.pad())


def test_train_batches_identical_and_open_the_dense_gate(setup):
    for name in ("infill", "summary"):
        for js, ts in zip(setup["jb"][name], setup["tb"][name]):
            for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"]):
                np.testing.assert_array_equal(np.asarray(a.value["inputs"]), b.value["inputs"])
                B, T = b.value["inputs"].shape
                assert B * T >= 256 and T <= 256
            np.testing.assert_array_equal(js["target"], ts["target"])
    # span masking ran: the infill source holds <mask> tokens
    mask_idx = setup["td"].index("<mask>")
    assert (setup["tb"]["infill"][0]["net_input"]["slots"][0].value["inputs"] == mask_idx).any()


def _jax_sample(s):
    return {"net_input": {"slots": s["net_input"]["slots"]}, "target": jnp.asarray(s["target"])}


def _stack(samples):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *samples)


def _models(setup):
    tm = setup["tm"]
    load_jax_params(tm.net, setup["params"])
    jcrit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=setup["pad"])
    tcrit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=setup["pad"])
    return tm, jcrit, tcrit


def _close_tree(t, j, what):
    flat_t = jax.tree_util.tree_leaves_with_path(t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        b = np.asarray(flat_j[path], np.float32)
        assert a.shape == b.shape, (jax.tree_util.keystr(path), a.shape, b.shape)
        err = np.abs(a - b).max()
        tol = what["atol"] + what["rtol"] * np.abs(b).max()
        noise = path[-1].key == "bias" and path[-2].key in NOISE_MODULES
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)
        if what.get("mean_atol") and not noise:
            mean = np.abs(a - b).mean()
            assert mean <= what["mean_atol"], (jax.tree_util.keystr(path), mean)


@pytest.mark.parametrize("mode", ["single", "update_freq2", "multitask"])
def test_train_step_matches_ofasys_tpu(setup, mode):
    tm, jcrit, tcrit = _models(setup)
    jm, pad = setup["jm"], setup["pad"]
    jb, tb = setup["jb"], setup["tb"]
    names = [n for n, _ in tm.net.named_parameters()]

    if mode == "single":
        jbatch, tbatch = _jax_sample(jb["summary"][0]), sample_to_device(tb["summary"][0], "cpu")
    elif mode == "update_freq2":
        shapes = {"slots": [max(np.asarray(b["net_input"]["slots"][i].value["inputs"]).shape[1]
                                for b in jb["infill"]) for i in range(2)],
                  "target": max(b["target"].shape[1] for b in jb["infill"])}
        jbatch = _jax_sample(_stack([_pad_to(b, shapes, pad) for b in jb["infill"]]))
        tbatch = [sample_to_device(_pad_to(b, shapes, pad), "cpu") for b in tb["infill"]]
    else:
        jbatch = {n: _jax_sample(jb[n][0]) for n in ("infill", "summary")}
        tbatch = {n: sample_to_device(tb[n][0], "cpu") for n in ("infill", "summary")}
    uf = 2 if mode == "update_freq2" else 1

    # gradients of the first update, leaf by leaf
    if mode == "multitask":
        jgrads = None
        tgrads = None
        for i, n in enumerate(("infill", "summary")):
            jg, _, _ = jax.jit(jts.make_grad_step(jm, jcrit, fold=i))(
                setup["params"], 0, jbatch[n], jax.random.PRNGKey(0))
            tg, _, _ = tts.make_grad_step(tm, tcrit, fold=i)(list(tm.net.parameters()), 0, tbatch[n], 0)
            jgrads = jg if jgrads is None else jax.tree.map(jnp.add, jgrads, jg)
            tgrads = tg if tgrads is None else [a + b for a, b in zip(tgrads, tg)]
    else:
        jgrads, _, _ = jax.jit(jts.make_grad_step(jm, jcrit, update_freq=uf))(
            setup["params"], 0, jbatch, jax.random.PRNGKey(0))
        tgrads, _, _ = tts.make_grad_step(tm, tcrit, update_freq=uf)(
            list(tm.net.parameters()), 0, tbatch, 0)
    _close_tree(export_params(tm.net, dict(zip(names, tgrads))), jax.device_get(jgrads),
                {"atol": GRAD_ATOL, "rtol": GRAD_RTOL})

    # three updates
    jopt = jbuild_optimizer(JOptimizationConfig(lr=(LR,)), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(lr=(LR,)), total_num_update=10)
    jstate = jts.TrainState.create(setup["params"], jopt)
    tstate = tts.TrainState.create(tm.net, topt)
    if mode == "multitask":
        crits = {"infill": jcrit, "summary": jcrit}
        jstep = jax.jit(jts.make_multitask_train_step(jm, crits, jopt))
        tstep = tts.make_multitask_train_step(tm, {"infill": tcrit, "summary": tcrit}, topt)
    else:
        jstep = jax.jit(jts.make_train_step(jm, jcrit, jopt, update_freq=uf))
        tstep = tts.make_train_step(tm, tcrit, topt, update_freq=uf)
    for _ in range(N_UPDATES):
        jstate, jmet = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        tstate, tmet = tstep(tstate, tbatch, 0)
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]), rtol=LOSS_RTOL)
        if mode == "multitask":
            for n in ("infill", "summary"):
                for key in ("loss", "nll_loss", "sample_size"):
                    np.testing.assert_allclose(float(tmet["tasks"][n][key]),
                                               float(jmet["tasks"][n][key]), rtol=LOSS_RTOL)
        else:
            for key in ("loss", "nll_loss", "sample_size", "ntokens"):
                np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=LOSS_RTOL)
    assert tstate.step == int(jstate.step) == N_UPDATES
    _close_tree(export_params(tm.net), jax.device_get(jstate.params),
                {"atol": 2 * N_UPDATES * LR, "rtol": 0.0, "mean_atol": PARAM_MEAN_ATOL})


# ------------------------------------------------------------------ dropout
def test_dropout_keep_rate_and_scale():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = tattn.dropout(x, 0.1, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.9, rtol=1e-6)
    assert tattn.dropout(x, 0.1, None) is x and tattn.dropout(x, 0.0, g) is x


def test_drop_path_keeps_whole_samples():
    x = torch.ones(20_000, 3, 4)
    y = drop_path(x, 0.25, torch.Generator().manual_seed(1))
    per_sample = y.reshape(20_000, -1)
    kept = per_sample[:, 0] != 0
    # one draw per sample: a sample is kept or dropped whole
    assert torch.equal(per_sample != 0, kept[:, None].expand_as(per_sample))
    assert abs(kept.float().mean().item() - 0.75) < 1e-2
    np.testing.assert_allclose(per_sample[kept].numpy(), 1.0 / 0.75, rtol=1e-6)


@pytest.fixture(scope="module")
def dropout_model():
    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _configure(tm, dropout=0.1)
    c = tm.cfg
    c.attention_dropout = c.activation_dropout = 0.1
    c.encode_drop_path_rate = c.decode_drop_path_rate = 0.2
    c.encoder.layerdrop = c.decoder.layerdrop = 0.3
    tgp = GeneralPreprocess(td, active=["text"])
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu", seed=3)
    infill, _ = _records(seed=5)
    sample = tgp.collate([tgp(Instruction(INFILL, split="train").format(**r)) for r in infill])
    return tm, sample_to_device(sample, "cpu")


def test_training_forward_is_random_eval_is_not(dropout_model):
    tm, sample = dropout_model
    slots = sample["net_input"]["slots"]
    with torch.no_grad():
        e1, _ = tm.apply_train(slots, deterministic=True, generator=torch.Generator().manual_seed(0))
        e2, _ = tm.apply(slots)
        t1, _ = tm.apply_train(slots, generator=torch.Generator().manual_seed(7))
        t2, _ = tm.apply_train(slots, generator=torch.Generator().manual_seed(7))
        t3, _ = tm.apply_train(slots, generator=torch.Generator().manual_seed(8))
    assert torch.equal(e1, e2)
    assert torch.equal(t1, t2)
    assert not torch.equal(t1, t3) and not torch.equal(t1, e1)


def test_attention_dropout_takes_the_plain_path(dropout_model):
    """A nonzero attention-dropout rate closes both kernel gates, as in
    ofasys_tpu: the training forward runs the plain attention, and the
    deterministic one the dense kernel's plain version."""
    tm, sample = dropout_model
    slots = sample["net_input"]["slots"]
    before = tdense.dense_attention_fwd.launches
    calls = []
    orig = tdense.dense_attention_fwd_reference
    tdense.dense_attention_fwd_reference = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            tm.apply_train(slots, generator=torch.Generator().manual_seed(0))
            n_train = len(calls)
            tm.apply_train(slots, deterministic=True)
    finally:
        tdense.dense_attention_fwd_reference = orig
    assert n_train == 0
    assert len(calls) == tm.cfg.encoder.layers + 2 * tm.cfg.decoder.layers
    assert tdense.dense_attention_fwd.launches == before


def test_train_step_with_dropout_is_reproducible(dropout_model):
    tm, sample = dropout_model
    crit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(),
                                              pad_id=tm.global_dict.pad())
    grad_step = tts.make_grad_step(tm, crit)
    params = list(tm.net.parameters())
    g1, ss1, l1 = grad_step(params, 4, sample, 123)
    g2, ss2, l2 = grad_step(params, 4, sample, 123)
    _, _, l3 = grad_step(params, 5, sample, 123)
    _, _, l4 = tts.make_grad_step(tm, crit, fold=1)(params, 4, sample, 123)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert float(l1["loss"]) == float(l2["loss"]) and float(ss1) == float(ss2)
    # the stream differs per step and per task
    assert float(l3["loss"]) != float(l1["loss"]) and float(l4["loss"]) != float(l1["loss"])


def test_valid_step_is_the_eval_loss(dropout_model):
    """make_valid_step: the criterion in eval mode (no dropout, no
    drop-worst), without gradients."""
    tm, sample = dropout_model
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(drop_worst_ratio=0.5), pad_id=tm.global_dict.pad())
    log1 = tts.make_valid_step(tm, crit)(sample)
    log2 = tts.make_valid_step(tm, crit)(sample)
    assert float(log1["loss"]) == float(log2["loss"]) and not log1["loss"].requires_grad
    assert int(log1["ntokens"]) == int((sample["target"] != tm.global_dict.pad()).sum())
