"""The training step (counterpart of ofasys_tpu/engine/train_step.py).

The step is factored into two halves, as in ofasys_tpu, so that the summed
multi-task update (gradients of every task's batch summed, then one
optimizer step) is built from the same pieces as the single-task one:

  make_grad_step   (params, step, batch, seed) -> (grads_raw, sample_size, logging)
  make_apply_step  (state, grads_raw, sample_size) -> (state, metrics)

Gradients are summed raw over the ``update_freq`` microbatches and over
tasks, then scaled once by ``1 / max(sample_size, 1)``: one big batch, k
microbatches and k task batches give the same update. ``gnorm`` is taken
after that scaling and before clipping.

Randomness: each microbatch of each task draws its dropout from its own
``torch.Generator`` on the model's device, seeded from ``(seed, step, task
index, microbatch index)``, which decorrelates the streams per step and
per task as ofasys_tpu's ``fold_in`` does. The numbers differ from JAX's.

A step updates the parameters, the optimizer state and the EMA in place
and returns the state with ``step`` advanced. Batches are samples whose
arrays are already tensors on the model's device
(:func:`ofasys_torch.utils.pytree.sample_to_device`); with
``update_freq > 1`` a batch is a list of ``update_freq`` such samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ofasys_torch.engine.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    params: List[torch.nn.Parameter]      # the net's parameters, in named order
    opt_state: Dict[str, Any]
    ema_params: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, net: torch.nn.Module, optimizer: Optimizer, ema: bool = False) -> "TrainState":
        params = list(net.parameters())
        return cls(
            step=0,
            params=params,
            opt_state=optimizer.init(params),
            ema_params=[p.detach().clone() for p in params] if ema else None,
        )


def dropout_generator(seed: int, step: int, fold: int, micro: int,
                      device: torch.device) -> torch.Generator:
    """The generator of one microbatch of one task at one step."""
    state = np.random.SeedSequence([seed, step, fold, micro]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1))


def _add_logs(acc: Optional[Dict[str, Any]], logging: Dict[str, Any]) -> Dict[str, Any]:
    if acc is None:
        return dict(logging)
    return {k: acc[k] + v for k, v in logging.items()}


def make_grad_step(model, criterion, update_freq: int = 1, fold: int = 0) -> Callable:
    """Gradient half: raw-summed gradients, sample size and logging.
    ``fold`` (the task index in the multi-task step) decorrelates the
    dropout streams of tasks that share one update."""

    def grad_step(params: List[torch.nn.Parameter], step: int, batch, seed: int):
        micro = batch if update_freq > 1 else [batch]
        if len(micro) != update_freq:
            raise ValueError(f"update_freq={update_freq} needs a list of {update_freq} samples")
        grads = sample_size = logs = None
        for i, mb in enumerate(micro):
            generator = dropout_generator(seed, step, fold, i, params[0].device)
            # update_num rides in the sample for criteria that gate on it
            loss, ss, logging = criterion(model, {**mb, "update_num": step}, generator, train=True)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x for x, p in zip(g, params)]
            if grads is None:
                grads, sample_size = g, ss
            else:
                torch._foreach_add_(grads, g)
                sample_size = sample_size + ss
            logs = _add_logs(logs, logging)
        return grads, sample_size, logs

    return grad_step


def make_apply_step(
    optimizer: Optimizer,
    ema_decay: float = 0.0,
    lr_schedule=None,
    ema_start_update: int = 0,
    ema_update_freq: int = 1,
) -> Callable:
    """Optimizer half: scale the raw gradient sum by ``1/sample_size``,
    clip and step (the optimizer), then the EMA, gated by its start update
    and update frequency."""

    @torch.no_grad()
    def apply_step(state: TrainState, grads: List[torch.Tensor], sample_size: torch.Tensor):
        scale = 1.0 / torch.clamp(torch.as_tensor(sample_size, dtype=torch.float32,
                                                  device=grads[0].device), min=1.0)
        grads = [g * scale for g in grads]
        gnorm = global_norm(grads)
        state.opt_state = optimizer.step(state.params, grads, state.opt_state)

        if state.ema_params is not None and ema_decay > 0:
            # before the start update the shadow tracks the raw params
            # (decay 0); after it, decay applies every ema_update_freq updates
            started = state.step >= ema_start_update
            due = state.step % max(ema_update_freq, 1) == 0
            decay = ema_decay if started else 0.0
            if started and not due:
                decay = 1.0
            for e, p in zip(state.ema_params, state.params):
                e.mul_(decay).add_(p.to(e.dtype) * (1.0 - decay))

        metrics = {"gnorm": gnorm}
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step)
        state.step += 1
        return state, metrics

    return apply_step


def make_train_step(
    model,
    criterion,
    optimizer: Optimizer,
    update_freq: int = 1,
    ema_decay: float = 0.0,
    lr_schedule=None,
    ema_start_update: int = 0,
    ema_update_freq: int = 1,
) -> Callable:
    """``train_step(state, batch, seed) -> (state, logging + metrics)``."""
    grad_step = make_grad_step(model, criterion, update_freq=update_freq)
    apply_step = make_apply_step(optimizer, ema_decay=ema_decay, lr_schedule=lr_schedule,
                                 ema_start_update=ema_start_update,
                                 ema_update_freq=ema_update_freq)

    def train_step(state: TrainState, batch, seed: int):
        grads, sample_size, logging = grad_step(state.params, state.step, batch, seed)
        state, metrics = apply_step(state, grads, sample_size)
        out = dict(logging)
        out.update(metrics)
        return state, out

    return train_step


def make_multitask_train_step(
    model,
    criteria: Dict[str, Any],            # task name -> criterion
    optimizer: Optimizer,
    update_freqs: Optional[Dict[str, int]] = None,
    ema_decay: float = 0.0,
    lr_schedule=None,
    ema_start_update: int = 0,
    ema_update_freq: int = 1,
) -> Callable:
    """One summed multi-task update: every task's gradients, their sum
    across tasks and one optimizer step.
    ``train_step(state, batches, seed) -> (state, metrics + {"tasks": ...})``."""
    update_freqs = update_freqs or {}
    grad_steps = {
        name: make_grad_step(model, crit, update_freq=update_freqs.get(name, 1), fold=i)
        for i, (name, crit) in enumerate(criteria.items())
    }
    apply_step = make_apply_step(optimizer, ema_decay=ema_decay, lr_schedule=lr_schedule,
                                 ema_start_update=ema_start_update,
                                 ema_update_freq=ema_update_freq)

    def train_step(state: TrainState, batches: Dict[str, Any], seed: int):
        acc_g = acc_ss = None
        task_logs = {}
        for name, gs in grad_steps.items():
            g, ss, logging = gs(state.params, state.step, batches[name], seed)
            task_logs[name] = logging
            if acc_g is None:
                acc_g, acc_ss = g, ss
            else:
                torch._foreach_add_(acc_g, g)
                acc_ss = acc_ss + ss
        state, metrics = apply_step(state, acc_g, acc_ss)
        out = dict(metrics)
        out["tasks"] = task_logs
        return state, out

    return train_step


def make_valid_step(model, criterion) -> Callable:
    @torch.no_grad()
    def valid_step(batch):
        _, _, logging = criterion(model, batch, None, train=False)
        return logging

    return valid_step
