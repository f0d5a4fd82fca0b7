"""Self-critical sequence training in ofasys_torch against ofasys_tpu:
``ScstRewardCriterion`` under ofasys_tpu's registry name
``scst_reward_criterion``, ``sample_and_reward`` (the sampling generator
and CIDEr-D), ``policy_gradient_loss`` (one teacher-forced scoring pass,
B-major, ``prev`` from id 0, padded to a multiple of 8, with and without
``ignore_prefix_size``) and ``scst_train_step`` on the port's TrainState
and optimizers.

The port's sampler cannot reproduce ofasys_tpu's ``jax.random`` stream, so
both packages score the same sampled tokens and advantages: the port's
samples feed ofasys_tpu's ``policy_gradient_loss``, and its
``sample_and_reward`` is replaced by the port's draws for the update.

Tiny arch (2+2 layers), fp32, the decode environment of
tests/test_torch_search.py (perturbed parameters). Tolerances: the loss
rtol 1e-5; gradients (scaled by 1 / ntokens, as the update applies them)
and the updated parameters atol 1e-6 + rtol 1e-4.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine.criterion import scst_loss as jscst
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.engine.train_step import TrainState as JTrainState
from ofasys_torch.configure.config_store import ConfigStore
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine.criterion import ScstRewardCriterion, ScstRewardCriterionConfig, scst_train_step
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.engine.train_step import TrainState
from ofasys_torch.generator import SequenceGenerator
from ofasys_torch.metric.metrics import CiderMetric
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.task.base import Task
from ofasys_torch.utils.jax_params import export_params, load_jax_params

from test_torch_search import _one_torch_thread, make_env, samples  # noqa: F401  (fixture)

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
N_SAMPLES = 3
RECS = [{"src": "hello world", "tgt": "x"}, {"src": "the quick brown fox", "tgt": "x"},
        {"src": "over the lazy dog", "tgt": "x"}]
REFS = [["hello world", "hello there"], ["a quick brown fox"], ["the lazy dog", "over a dog"]]


@pytest.fixture(scope="module")
def env():
    return make_env()


def _criterion(env, **kw):
    """The port's criterion with its sampling generator (top-k 50)."""
    cfg = ScstRewardCriterionConfig(scst_n_samples=N_SAMPLES, **kw)
    tm = env["tms"][0]
    gen = SequenceGenerator(tm, env["td"], beam_size=1, sampling=True, sampling_topk=cfg.sampling_topk,
                            max_len_b=8)
    return ScstRewardCriterion(cfg, pad_id=env["td"].pad()).setup(gen, env["tgp"].name2pre["text"])


def test_sample_and_reward(env):
    """n * B samples, sample-major, each ending in EOS; rewards (n, B) are
    each sample's CIDEr-D against its references; advantages have mean 0
    over the samples; the same seed repeats its draws."""
    crit = _criterion(env)
    _, ts = samples(env, RECS)
    toks, R, adv = crit.sample_and_reward(ts, REFS, seed=3)
    assert len(toks) == N_SAMPLES * len(RECS) and R.shape == adv.shape == (N_SAMPLES, len(RECS))
    assert all(t[-1] == env["td"].eos() for t in toks)
    cider = CiderMetric()
    text = env["tgp"].name2pre["text"]
    for i, t in enumerate(toks):
        s, b = divmod(i, len(RECS))
        assert R[s, b] == np.float32(cider.compute([text.decode(t)], [REFS[b]])["cider"])
    np.testing.assert_allclose(adv.mean(axis=0), 0.0, atol=1e-6)
    np.testing.assert_allclose(adv, R - R.mean(axis=0, keepdims=True))
    again, R2, _ = crit.sample_and_reward(ts, REFS, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(toks, again)) and np.array_equal(R, R2)


@pytest.mark.parametrize("ignore_prefix", [0, 2])
def test_policy_gradient_loss_and_gradients_match(env, ignore_prefix):
    crit = _criterion(env, ignore_prefix_size=ignore_prefix)
    js, ts = samples(env, RECS)
    toks, _, adv = crit.sample_and_reward(ts, REFS, seed=0)
    # a nonzero advantage everywhere, so every sequence's gradient counts
    adv = adv + np.linspace(0.1, 0.9, adv.size, dtype=np.float32).reshape(adv.shape)
    jcrit = jscst.ScstRewardCriterion(jscst.ScstRewardCriterionConfig(
        scst_n_samples=N_SAMPLES, ignore_prefix_size=ignore_prefix), pad_id=env["jd"].pad())
    params = env["params"][0]
    loss_fn = jcrit.policy_gradient_loss(env["jm"], params, js, toks, adv)
    (jl, jn), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tm = env["tms"][0]
    load_jax_params(tm.net, params)
    tm.net.zero_grad()
    tl, tn = crit.policy_gradient_loss(tm, ts, toks, adv)
    tl.backward()
    assert int(tn) == int(jn)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    # compared as scst_train_step applies them: scaled by 1 / ntokens
    scale = 1.0 / int(tn)
    tgrads = export_params(tm.net, {n: torch.zeros_like(p) if p.grad is None else p.grad * scale
                                    for n, p in tm.net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, g in jax.tree_util.tree_leaves_with_path(tgrads):
        np.testing.assert_allclose(g, np.asarray(flat_j[path]) * scale, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_scst_train_step_matches(env, monkeypatch):
    """One update under sgd at a fixed lr of 0.5 without clipping, on the
    same samples: the reported loss and reward, and every parameter after
    the step."""
    crit = _criterion(env)
    js, ts = samples(env, RECS)
    toks, R, adv = crit.sample_and_reward(ts, REFS, seed=1)
    # random weights score every sample alike: a spread of advantages moves the parameters
    draws = (toks, R, adv + np.linspace(-0.5, 0.5, adv.size, dtype=np.float32).reshape(adv.shape))
    crit.sample_and_reward = lambda *a, **k: draws
    params = env["params"][0]
    jcrit = jscst.ScstRewardCriterion(jscst.ScstRewardCriterionConfig(scst_n_samples=N_SAMPLES),
                                      pad_id=env["jd"].pad())
    monkeypatch.setattr(jcrit, "sample_and_reward", lambda *a, **k: draws)
    # ofasys_tpu's step takes value_and_grad eagerly, op by op: compiled
    # here, the same function (about 35 s of dispatch on the CPU saved)
    value_and_grad = jax.value_and_grad
    monkeypatch.setattr(jax, "value_and_grad", lambda f, **kw: jax.jit(value_and_grad(f, **kw)))
    jcfg, tcfg = JOptimizationConfig(), OptimizationConfig()
    for c in (jcfg, tcfg):
        c.optimizer, c.lr_scheduler, c.lr, c.clip_norm = "sgd", "fixed", (0.5,), 0.0
    jopt = jbuild_optimizer(jcfg)
    jstate, jout = jscst.scst_train_step(jcrit, env["jm"], JTrainState.create(params, jopt), jopt,
                                         js, REFS, seed=1)

    tm = copy.deepcopy(env["tms"][0])
    load_jax_params(tm.net, params)
    topt = build_optimizer(tcfg)
    state = TrainState.create(tm.net, topt)
    state, tout = scst_train_step(crit, tm, state, topt, ts, REFS, seed=1)
    assert state.step == 1 and int(jstate.step) == 1
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=LOSS_RTOL)
    assert tout["reward"] == pytest.approx(jout["reward"], rel=1e-6)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params)))
    after = jax.tree_util.tree_leaves_with_path(export_params(tm.net))
    for path, p in after:
        np.testing.assert_allclose(p, np.asarray(flat_j[path]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    before = dict(jax.tree_util.tree_leaves_with_path(params))
    assert any(not np.array_equal(p, np.asarray(before[path])) for path, p in after)


def test_per_sample_cider_is_zero_as_in_ofasys_tpu():
    """sample_and_reward scores one hypothesis at a time against its
    references, as ofasys_tpu does: over a corpus of one document every
    n-gram's idf is log(1) - log(1) = 0, so the reward is 0 even for a
    hypothesis equal to a reference, in both packages (ROADMAP Queue C)."""
    from ofasys_tpu.metric.metrics import CiderMetric as JCiderMetric

    refs = ["a man rides a horse on the beach", "a rider on a horse"]
    for metric in (CiderMetric(), JCiderMetric()):
        assert metric.compute([refs[0]], [refs])["cider"] == 0.0
        assert metric.compute([refs[0], "two dogs"], [refs, ["two dogs play"]])["cider"] > 0.0


def test_registered_under_ofasys_tpus_name():
    """``scst_reward_criterion`` builds the criterion through a task, whose
    ``__call__`` points at scst_train_step; no package registers
    ``scst_loss``."""
    from ofasys_tpu.configure import ConfigStore as JConfigStore
    import ofasys_tpu.engine.criterion  # noqa: F401

    task = Task(name="caption_scst", instruction="[TEXT:src] -> [TEXT:tgt]",
                criterion="scst_reward_criterion").initialize(Dictionary())
    assert isinstance(task.criterion, ScstRewardCriterion)
    assert task.criterion.cfg.scst_n_samples == 5 and task.criterion.cfg.sampling_topk == 50
    with pytest.raises(NotImplementedError, match="scst_train_step"):
        task.criterion(None, {}, None)
    for store in (ConfigStore(), JConfigStore()):
        assert store.contains("ofasys.criterion", "scst_reward_criterion")
        assert not store.contains("ofasys.criterion", "scst_loss")
    with pytest.raises(KeyError, match="scst_loss"):
        Task(name="x", instruction="[TEXT:src] -> [TEXT:tgt]", criterion="scst_loss").initialize(Dictionary())
