"""Optimizers and learning-rate schedules (counterpart of
ofasys_tpu/engine/optim.py).

The semantics are optax's, which ofasys_tpu builds its optimizers from
with optax's defaults, and not ``torch.optim``'s:

  * the schedule is read at the update count before the increment, so with
    ``warmup_updates > 0`` the first update has learning rate 0;
  * global-norm clipping, chained before every optimizer, scales the
    gradients by ``c / |g|`` only when ``|g| >= c``, with no epsilon;
  * adam/adamw: bias correction with ``count + 1``, ``eps`` added outside
    the square root, weight decay ``wd * p`` added to the update before the
    learning rate scales it (``optax.adamw``);
  * adafactor, sgd, nag, adagrad, adadelta and adamax as the classes below
    write out, each with the optax defaults it names;
  * every moment is fp32.

An :class:`Optimizer` is functional, like an optax transformation:
``init(params)`` returns the state, ``step(params, grads, state)`` updates
the parameters in place (under ``no_grad``) and returns the new state.
Parameters and gradients are lists of tensors in one order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.configure.configs import OptimizationConfig

Schedule = Callable[[int], float]


def polynomial_decay_schedule(
    lr: float,
    total_num_update: int,
    warmup_updates: int = 0,
    warmup_ratio: float = 0.0,
    end_learning_rate: float = 0.0,
    power: float = 1.0,
) -> Schedule:
    """Linear warmup, then polynomial decay to ``end_learning_rate`` at
    ``total_num_update``; float32 arithmetic, as ofasys_tpu computes it."""
    if warmup_ratio > 0:
        warmup_updates = int(warmup_ratio * total_num_update)
    f32 = np.float32
    warm = f32(max(warmup_updates, 0))
    total = f32(max(total_num_update, 1))

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warm:
            return float(f32(lr) * s / max(warm, f32(1.0)))
        pct = f32(1.0) - (s - warm) / max(total - warm, f32(1.0))
        pct = min(max(pct, f32(0.0)), f32(1.0))
        return float((f32(lr) - f32(end_learning_rate)) * pct ** f32(power) + f32(end_learning_rate))

    return schedule


def build_lr_schedule(cfg: OptimizationConfig, total_num_update: Optional[int] = None) -> Schedule:
    total = total_num_update or cfg.total_num_update or cfg.max_update or 100000
    name = cfg.lr_scheduler
    if name in ("ofa_polynomial_decay", "polynomial_decay"):
        return polynomial_decay_schedule(
            lr=cfg.lr[0],
            total_num_update=total,
            warmup_updates=cfg.warmup_updates,
            warmup_ratio=cfg.warmup_ratio,
            end_learning_rate=cfg.end_learning_rate,
            power=cfg.power,
        )
    if name in ("fixed", "constant"):
        return lambda step: float(cfg.lr[0])
    if name == "inverse_sqrt":
        warm = max(cfg.warmup_updates, 1)
        # optax.join_schedules hands the second piece the steps since warm
        return lambda step: (cfg.lr[0] * step / warm if step < warm
                             else cfg.lr[0] * (warm / step) ** 0.5)
    raise ValueError(f"unknown lr scheduler {name!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the fp32 sum of squares of every element (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return float(np.float32(x))


class Optimizer:
    """``clip_by_global_norm`` (when ``clip_norm > 0``) chained with one
    optimizer's update, which a subclass gives as ``_init`` (its state per
    parameter) and ``_update`` (the updates, to be added to the parameters,
    and the new per-parameter state)."""

    def __init__(self, schedule: Schedule, clip_norm: float):
        self.schedule = schedule
        self.clip_norm = clip_norm

    def init(self, params: List[torch.Tensor]) -> Dict[str, object]:
        return {"count": 0, **self._init(params)}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict[str, object]) -> Dict[str, object]:
        grads = [g.float() for g in grads]
        if self.clip_norm and self.clip_norm > 0:
            # t if |g| < c, else (t / |g|) * c, decided on the device
            g_norm = global_norm(grads)
            below = g_norm < self.clip_norm
            grads = [torch.where(below, g, g / g_norm * self.clip_norm) for g in grads]
        count = state["count"]
        lr = _f32(self.schedule(count))
        upd, new = self._update(params, grads, state, count, lr)
        torch._foreach_add_(params, upd)
        return {"count": count + 1, **new}

    def _init(self, params):
        raise NotImplementedError

    def _update(self, params, grads, state, count: int, lr: float):
        raise NotImplementedError


class AdamW(Optimizer):
    """``optax.adamw`` (``weight_decay`` 0: ``optax.adam``)."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float):
        super().__init__(schedule, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def _init(self, params):
        return {"mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def _update(self, params, grads, state, count, lr):
        mu, nu = state["mu"], state["nu"]
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        c = count + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(c))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(c))
        # update = mu_hat / (sqrt(nu_hat) + eps) + wd p, then scaled by -lr
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        return upd, {"mu": mu, "nu": nu}


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice: (d1, d0), the second-largest and the largest axis
    (``np.argsort`` of the shape), when the second-largest has at least
    ``min_dim_size_to_factor`` entries; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """``optax.adafactor(lr)`` with its defaults: ``min_dim_size_to_factor``
    128, ``decay_rate`` 0.8, ``decay_offset`` 0, ``eps`` 1e-30, factored
    second moments, ``clipping_threshold`` 1.0 (block-RMS clipping),
    ``multiply_by_parameter_scale`` (the update times the parameter's RMS,
    at least 1e-3), no momentum, no weight decay. A factored parameter keeps
    row and column means of ``g^2 + eps``; any other its full second moment."""

    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    DECAY_OFFSET = 0
    EPS = 1e-30
    CLIPPING_THRESHOLD = 1.0
    MIN_PARAM_SCALE = 1e-3

    def _init(self, params):
        state = {"v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = _factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
            z1 = torch.zeros((1,), dtype=torch.float32, device=p.device)
            if dims is not None:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"].append(torch.zeros(shape[:d0] + shape[d0 + 1:], device=p.device))
                state["v_col"].append(torch.zeros(shape[:d1] + shape[d1 + 1:], device=p.device))
                state["v"].append(z1)
            else:
                state["v_row"].append(z1)
                state["v_col"].append(z1.clone())
                state["v"].append(torch.zeros_like(p, dtype=torch.float32))
        return state

    def _update(self, params, grads, state, count, lr):
        t = torch.tensor(count - self.DECAY_OFFSET + 1, dtype=torch.float32)
        decay = (1.0 - t ** (-self.DECAY_RATE)).item()   # an fp32 value
        upd, v_row, v_col, v = [], [], [], []
        for p, g, vr, vc, vv in zip(params, grads, state["v_row"], state["v_col"], state["v"]):
            g_sqr = g * g + self.EPS
            dims = _factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is not None:
                d1, d0 = dims
                vr = decay * vr + (1.0 - decay) * g_sqr.mean(dim=d0)
                vc = decay * vc + (1.0 - decay) * g_sqr.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (vr / vr.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            else:
                vv = decay * vv + (1.0 - decay) * g_sqr
                u = g * vv ** -0.5
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / self.CLIPPING_THRESHOLD, min=1.0)
            u = u * lr
            pf = p.float()
            rms = torch.sqrt((pf * pf).mean())
            u = u * torch.where(rms <= self.MIN_PARAM_SCALE, self.MIN_PARAM_SCALE, rms)
            upd.append(-u)
            v_row.append(vr)
            v_col.append(vc)
            v.append(vv)
        return upd, {"v_row": v_row, "v_col": v_col, "v": v}


class SGD(Optimizer):
    """``optax.sgd(lr)``; with ``momentum`` the trace ``t = g + m t`` (fp32)
    and, with ``nesterov``, the update ``g + m t`` (nag: momentum 0.99,
    Nesterov)."""

    def __init__(self, schedule: Schedule, clip_norm: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(schedule, clip_norm)
        self.momentum, self.nesterov = momentum, nesterov

    def _init(self, params):
        if self.momentum is None:
            return {}
        return {"trace": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def _update(self, params, grads, state, count, lr):
        if self.momentum is None:
            return [-lr * g for g in grads], {}
        m = self.momentum
        trace = [g + m * t for g, t in zip(grads, state["trace"])]
        u = [g + m * t for g, t in zip(grads, trace)] if self.nesterov else trace
        return [-lr * x for x in u], {"trace": trace}


class Adagrad(Optimizer):
    """``optax.adagrad(lr)``: ``initial_accumulator_value`` 0.1, ``eps``
    1e-7; the update ``g / sqrt(sum g^2 + eps)`` (0 where the sum is 0)."""

    INITIAL_ACCUMULATOR_VALUE = 0.1
    EPS = 1e-7

    def _init(self, params):
        return {"sum_of_squares": [torch.full_like(p, self.INITIAL_ACCUMULATOR_VALUE,
                                                   dtype=torch.float32) for p in params]}

    def _update(self, params, grads, state, count, lr):
        sos = [g * g + t for g, t in zip(grads, state["sum_of_squares"])]
        upd = [-lr * (torch.where(t > 0, torch.rsqrt(t + self.EPS), 0.0) * g)
               for g, t in zip(grads, sos)]
        return upd, {"sum_of_squares": sos}


class Adadelta(Optimizer):
    """``optax.adadelta(lr)``: ``rho`` 0.9, ``eps`` 1e-6, weight decay 0;
    the update ``sqrt(E[x^2] + eps) / sqrt(E[g^2] + eps) * g`` with
    E[g^2] updated before and E[x^2] after it."""

    RHO = 0.9
    EPS = 1e-6

    def _init(self, params):
        return {"e_g": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "e_x": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def _update(self, params, grads, state, count, lr):
        rho, eps = self.RHO, self.EPS
        e_g = [(1 - rho) * (g * g) + rho * t for g, t in zip(grads, state["e_g"])]
        u = [torch.sqrt(x + eps) / torch.sqrt(eg + eps) * g
             for g, eg, x in zip(grads, e_g, state["e_x"])]
        e_x = [(1 - rho) * (x * x) + rho * t for x, t in zip(u, state["e_x"])]
        return [-lr * x for x in u], {"e_g": e_g, "e_x": e_x}


class Adamax(Optimizer):
    """``optax.adamax(lr, b1, b2, eps)``: ``mu = (1 - b1) g + b1 mu``, the
    infinity moment ``nu = max(|g| + eps, b2 nu)``, the update
    ``mu / (1 - b1^count) / nu`` (count after the increment)."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float, clip_norm: float):
        super().__init__(schedule, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, params):
        return {"mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params]}

    def _update(self, params, grads, state, count, lr):
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * t for g, t in zip(grads, state["mu"])]
        nu = [torch.maximum(g.abs() + self.eps, b2 * t) for g, t in zip(grads, state["nu"])]
        bc = float(np.float32(1.0) - np.float32(b1) ** np.float32(count + 1))
        return [-lr * ((m / bc) / n) for m, n in zip(mu, nu)], {"mu": mu, "nu": nu}


def build_optimizer(cfg: OptimizationConfig, total_num_update: Optional[int] = None) -> Optimizer:
    """adam/adamw/adafactor/sgd/nag/adagrad/adadelta/adamax behind
    ofasys_tpu's optimizer names, each as ofasys_tpu's optax call builds it,
    after global-norm clipping when ``clip_norm > 0``."""
    schedule = build_lr_schedule(cfg, total_num_update)
    name, clip = cfg.optimizer, cfg.clip_norm
    if name in ("adam", "adamw"):
        use_w = cfg.use_adamw or name == "adamw" or cfg.weight_decay > 0
        return AdamW(schedule, b1=cfg.adam_betas[0], b2=cfg.adam_betas[1], eps=cfg.adam_eps,
                     weight_decay=cfg.weight_decay if use_w else 0.0, clip_norm=clip)
    if name == "adafactor":
        return Adafactor(schedule, clip)
    if name == "sgd":
        return SGD(schedule, clip)
    if name == "nag":
        return SGD(schedule, clip, momentum=0.99, nesterov=True)
    if name == "adagrad":
        return Adagrad(schedule, clip)
    if name == "adadelta":
        return Adadelta(schedule, clip)
    if name == "adamax":
        return Adamax(schedule, b1=cfg.adam_betas[0], b2=cfg.adam_betas[1], eps=cfg.adam_eps,
                      clip_norm=clip)
    raise ValueError(f"unknown optimizer {name!r}")
