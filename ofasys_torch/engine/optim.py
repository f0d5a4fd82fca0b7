"""Optimizer and learning-rate schedule (counterpart of
ofasys_tpu/engine/optim.py).

The semantics are optax's, which ofasys_tpu builds its optimizer from, and
not ``torch.optim``'s defaults:

  * the schedule is read at the update count before the increment, so with
    ``warmup_updates > 0`` the first update has learning rate 0;
  * Adam's bias correction uses ``count + 1``; ``eps`` is added outside the
    square root; moments are fp32;
  * weight decay adds ``wd * p`` to every parameter's update before the
    learning rate scales it (``optax.adamw``);
  * global-norm clipping scales the gradients by ``c / |g|`` only when
    ``|g| >= c``, with no epsilon.

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


class Optimizer:
    """``clip_by_global_norm`` (when ``clip_norm > 0``) chained with
    ``adamw``, as ``build_optimizer`` chains them in ofasys_tpu."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: List[torch.Tensor]) -> Dict[str, object]:
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
        }

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
        lr = float(np.float32(self.schedule(count)))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return {"count": c, "mu": mu, "nu": nu}


def build_optimizer(cfg: OptimizationConfig, total_num_update: Optional[int] = None) -> Optimizer:
    """adam/adamw behind ofasys_tpu's optimizer names; the others that
    ofasys_tpu builds (adafactor, sgd, nag, adagrad, adadelta, adamax) raise."""
    schedule = build_lr_schedule(cfg, total_num_update)
    name = cfg.optimizer
    if name not in ("adam", "adamw"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to ofasys_torch yet (adam and adamw are)")
    use_w = cfg.use_adamw or name == "adamw" or cfg.weight_decay > 0
    return Optimizer(schedule, b1=cfg.adam_betas[0], b2=cfg.adam_betas[1], eps=cfg.adam_eps,
                     weight_decay=cfg.weight_decay if use_w else 0.0, clip_norm=cfg.clip_norm)
