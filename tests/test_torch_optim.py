"""The port's optimizer and learning-rate schedule against ofasys_tpu's
(optax).

Schedule values are compared exactly up to one fp32 rounding (both compute
in float32). Five adamw updates with global-norm clipping run on a small
tree of fp32 parameters with gradients from a numpy seed, on both sides;
the gradients of some updates are scaled so that clipping triggers on them
and not on others. Tolerance on the parameters: atol 1e-6 (lr 1e-2 times
an Adam step of order 1, computed in fp32 in another order).

The other six optimizers (adafactor, sgd, nag, adagrad, adadelta, adamax)
run 3 updates with clipping, warm-up and a decaying schedule against
ofasys_tpu's optax chain, on parameters that include matrices adafactor
factors (second-largest dimension >= 128, also a 3-D one) and ones it does
not: rtol 1e-5 + atol 1e-7 (the same fp32 formulas in another order; the
atol, a few fp32 ulps of an update of size lr = 3e-2, covers entries that
an update leaves near zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.optim import build_lr_schedule as jbuild_lr_schedule
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.engine.optim import polynomial_decay_schedule as jschedule
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.optim import build_lr_schedule, build_optimizer, polynomial_decay_schedule


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, total_num_update=100, warmup_updates=10),
    dict(lr=5e-4, total_num_update=50, warmup_ratio=0.1, end_learning_rate=1e-5, power=2.0),
    dict(lr=1e-4, total_num_update=20),
], ids=["warmup", "ratio_power_end", "no_warmup"])
def test_polynomial_decay_schedule(kw):
    j, t = jschedule(**kw), polynomial_decay_schedule(**kw)
    # warm-up, decay, the end and past it
    for step in (0, 1, 4, 5, 9, 10, 11, 30, 49, 50, 99, 100, 150):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=2e-7, atol=0)


@pytest.mark.parametrize("name", ["fixed", "inverse_sqrt"])
def test_other_schedules(name):
    cfg = dict(lr=(3e-4,), lr_scheduler=name, warmup_updates=4)
    j = jbuild_lr_schedule(JOptimizationConfig(**cfg), total_num_update=50)
    t = build_lr_schedule(OptimizationConfig(**cfg), total_num_update=50)
    for step in (0, 1, 3, 4, 5, 17, 49):
        np.testing.assert_allclose(t(step), float(j(jnp.int32(step))), rtol=1e-6, atol=0)


SHAPES = [(8, 4), (4,), (3, 5, 2)]
# scale of each update's gradients: 1e-2 keeps the global norm below the
# clip of 1.0, 10 pushes it above
GRAD_SCALES = [1e-2, 10.0, 1e-2, 10.0, 1.0]


@pytest.mark.parametrize("opts", [
    dict(lr=(1e-2,)),
    dict(lr=(1e-2,), warmup_updates=2),
    dict(lr=(1e-2,), weight_decay=0.0, use_adamw=False, clip_norm=0.0),
    dict(lr=(1e-2,), adam_betas=(0.8, 0.99), adam_eps=1e-6, weight_decay=0.1),
], ids=["adamw_clip", "warmup", "adam_no_clip", "betas_eps_wd"])
def test_adamw_with_clipping_matches_optax(opts):
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
             for scale in GRAD_SCALES]

    jopt = jbuild_optimizer(JOptimizationConfig(**opts), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(**opts), total_num_update=10)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    clipped = []
    for g in grads:
        clipped.append(float(optax.global_norm([jnp.asarray(x) for x in g])) >= 1.0)
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = topt.step(tp, [torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert tstate["count"] == len(grads)
    assert any(clipped) and not all(clipped)
    if opts.get("warmup_updates"):
        # the schedule is read before the increment: lr 0 on the first update
        topt2 = build_optimizer(OptimizationConfig(**opts), total_num_update=10)
        p0 = [torch.from_numpy(p.copy()) for p in params]
        topt2.step(p0, [torch.from_numpy(x) for x in grads[0]], topt2.init(p0))
        assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(p0, params))


OTHER_SHAPES = [(8, 4), (4,), (3, 5, 2), (130, 200), (256, 128), (160, 3, 140)]


@pytest.mark.parametrize("name", ["adafactor", "sgd", "nag", "adagrad", "adadelta", "adamax"])
@pytest.mark.parametrize("opts", [dict(lr=(1e-2,), warmup_updates=1),
                                  dict(lr=(3e-2,), clip_norm=0.0, adam_betas=(0.8, 0.95), adam_eps=1e-6)],
                         ids=["clip_warmup", "no_clip_betas"])
def test_other_optimizers_match_optax(name, opts):
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in OTHER_SHAPES]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in OTHER_SHAPES]
             for scale in (1e-2, 10.0, 1.0)]
    cfg = dict(opts, optimizer=name)
    jopt = jbuild_optimizer(JOptimizationConfig(**cfg), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(**cfg), total_num_update=10)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = topt.step(tp, [torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert tstate["count"] == len(grads)
    assert all(s.dtype == torch.float32 for v in tstate.values() if isinstance(v, list) for s in v)
    assert not all(np.array_equal(a.numpy(), b) for a, b in zip(tp, params))


def test_adafactor_defaults_are_optax():
    """The constants the port writes out are optax.adafactor's defaults, and
    the factored second moments are kept for the matrices optax factors."""
    import inspect

    from ofasys_torch.engine.optim import Adafactor

    d = {k: v.default for k, v in inspect.signature(optax.adafactor).parameters.items()}
    assert (Adafactor.MIN_DIM_SIZE_TO_FACTOR, Adafactor.DECAY_RATE, Adafactor.DECAY_OFFSET,
            Adafactor.CLIPPING_THRESHOLD, Adafactor.EPS) == (
        d["min_dim_size_to_factor"], d["decay_rate"], d["decay_offset"], d["clipping_threshold"],
        d["eps"])
    assert d["multiply_by_parameter_scale"] is True and d["momentum"] is None and d["factored"] is True
    opt = build_optimizer(OptimizationConfig(optimizer="adafactor"))
    state = opt.init([torch.zeros(130, 200), torch.zeros(8, 4)])
    assert state["v_row"][0].shape == (130,) and state["v_col"][0].shape == (200,)
    assert state["v"][1].shape == (8, 4)


@pytest.mark.parametrize("name,defaults", [
    ("adagrad", dict(initial_accumulator_value=0.1, eps=1e-7)),
    ("adadelta", dict(rho=0.9, eps=1e-6, weight_decay=0.0)),
])
def test_optax_defaults_written_out(name, defaults):
    import inspect

    from ofasys_torch.engine import optim

    d = {k: v.default for k, v in inspect.signature(getattr(optax, name)).parameters.items()}
    assert {k: d[k] for k in defaults} == defaults
    cls = {"adagrad": optim.Adagrad, "adadelta": optim.Adadelta}[name]
    if name == "adagrad":
        assert (cls.INITIAL_ACCUMULATOR_VALUE, cls.EPS) == (0.1, 1e-7)
    else:
        assert (cls.RHO, cls.EPS) == (0.9, 1e-6)


def test_unported_optimizer_raises():
    """Adafactor, which raised before it was ported (the name is kept),
    now builds; an unknown optimizer or scheduler raises ValueError, as in
    ofasys_tpu."""
    opt = build_optimizer(OptimizationConfig(optimizer="adafactor"))
    p = [torch.ones(4, 3)]
    state = opt.step(p, [torch.full((4, 3), 0.5)], opt.init(p))
    assert state["count"] == 1 and torch.isfinite(p[0]).all()
    with pytest.raises(ValueError):
        build_optimizer(OptimizationConfig(optimizer="lamb"))
    with pytest.raises(ValueError):
        build_optimizer(OptimizationConfig(lr_scheduler="cosine_whatever"))


def test_apply_step_with_ema_matches_ofasys_tpu():
    """make_apply_step on its own: the 1/sample_size scaling, gnorm before
    clipping, the optimizer and the EMA gated by its start update and
    update frequency (decay 0 before the start, 1 off the frequency)."""
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    cfg = dict(lr=(1e-2,))
    jopt = jbuild_optimizer(JOptimizationConfig(**cfg), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(**cfg), total_num_update=10)
    kw = dict(ema_decay=0.9, ema_start_update=2, ema_update_freq=2)
    japply = jts.make_apply_step(jopt, **kw)
    tapply = tts.make_apply_step(topt, **kw)
    jstate = jts.TrainState.create([jnp.asarray(p) for p in params], jopt, ema=True)
    tstate = tts.TrainState.create(
        torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]),
        topt, ema=True)
    for i in range(5):
        g = [(40.0 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
        ss = float(8 + i)
        jstate, jm = japply(jstate, [jnp.asarray(x) for x in g], jnp.float32(ss))
        tstate, tm = tapply(tstate, [torch.from_numpy(x) for x in g], torch.tensor(ss))
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]), rtol=1e-6)
        for a, b in zip(tstate.params, jstate.params):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
        for a, b in zip(tstate.ema_params, jstate.ema_params):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert tstate.step == int(jstate.step) == 5
