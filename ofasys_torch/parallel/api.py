"""Sharded training steps (counterpart of ofasys_tpu/parallel/api.py).

ofasys_tpu jits its train step with shardings and lets XLA insert the
collectives. Here each rank runs the port's own steps
(engine/train_step.py) on its rows of the batch, wrapped so that the
update equals the one-process update on the global batch:

  * the gradient half runs on this rank's rows (``put_batch``), with its
    dropout drawn from the rank's own stream (``shard``) and, under fsdp,
    the parameters gathered as they are used (``Layout.unsharded`` and the
    layers' own gathers); the gradients, the sample size and the logged
    sums are summed over data x fsdp, and the gradients of fsdp-sliced
    leaves come out as this rank's slice (reduce-scattered in the
    backward), as ofasys_tpu's come out sharded like the params;
  * the optimizer half takes the global norm over the mesh and steps this
    rank's slices (parallel/sharding.Layout); under zero1 it all-gathers
    them back into the whole parameters.

Tensor, sequence, expert and pipeline parallelism live in the model
(parallel/sharding.shard_model, ring attention, MoE, the pipeline); their
collectives run inside the forward and backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ofasys_torch.engine.train_step import TrainState, make_apply_step, make_grad_step
from ofasys_torch.parallel.mesh import Mesh, batch_rows
from ofasys_torch.parallel.sharding import Layout


def shard_train_state(layout: Layout, optimizer, ema: bool = False) -> TrainState:
    """The TrainState of this rank: its stage's parameters, the optimizer
    state of its slices, the EMA of its parameters."""
    from ofasys_torch.engine.optim import Adafactor

    if isinstance(optimizer, Adafactor) and any(
            lf.opt_dim is not None or lf.model_axes for lf in layout.leaves):
        raise ValueError("adafactor's factored moments need whole leaves: shard it with data "
                         "parallelism only (no fsdp, zero1, tensor, expert or pipeline slices)")
    params = layout.params
    return TrainState(step=0, params=params, opt_state=optimizer.init(layout.views(params)),
                      ema_params=[p.detach().clone() for p in params] if ema else None)


def _reduce_logs(layout: Layout, logging: Dict[str, Any]) -> Dict[str, Any]:
    return {k: layout.reduce_sum(v) if isinstance(v, (torch.Tensor, int, float)) else v
            for k, v in logging.items()}


def make_sharded_grad_step(grad_step: Callable, layout: Layout) -> Callable:
    """``grad_step(params, step, batch, seed)`` (made with ``shard=
    layout.data_shard``) on this rank's rows, its gradients, sample size and
    logged sums summed over data x fsdp."""

    def step(params, step_no: int, batch, seed: int):
        with layout.unsharded():
            grads, ss, logs = grad_step(params, step_no, batch, seed)
        return layout.reduce_grads(grads), layout.reduce_sum(ss), _reduce_logs(layout, logs)

    return step


def make_sharded_apply_step(optimizer, layout: Layout, **kwargs) -> Callable:
    """The optimizer half over the layout's slices (``make_apply_step`` with
    ``layout``); ``kwargs`` as ``make_apply_step``'s."""
    return make_apply_step(optimizer, layout=layout, **kwargs)


def make_sharded_train_step(model, criterion, optimizer, layout: Layout, update_freq: int = 1,
                            **kwargs) -> Callable:
    """``train_step(state, batch, seed) -> (state, logging + metrics)`` of
    this rank (``batch`` its rows, ``put_batch``)."""
    grad_step = make_sharded_grad_step(
        make_grad_step(model, criterion, update_freq=update_freq, shard=layout.data_shard), layout)
    apply_step = make_sharded_apply_step(optimizer, layout, **kwargs)

    def train_step(state: TrainState, batch, seed: int):
        grads, sample_size, logging = grad_step(state.params, state.step, batch, seed)
        state, metrics = apply_step(state, grads, sample_size)
        out = dict(logging)
        out.update(metrics)
        return state, out

    return train_step


def make_sharded_multitask_train_step(model, criteria: Dict[str, Any], optimizer, layout: Layout,
                                      update_freqs: Optional[Dict[str, int]] = None,
                                      **kwargs) -> Callable:
    """The summed multi-task update of this rank: every task's gradients
    on its rows, summed over tasks and ranks, one optimizer step."""
    update_freqs = update_freqs or {}
    grad_steps = {
        name: make_sharded_grad_step(
            make_grad_step(model, crit, update_freq=update_freqs.get(name, 1), fold=i,
                           shard=layout.data_shard), layout)
        for i, (name, crit) in enumerate(criteria.items())
    }
    apply_step = make_sharded_apply_step(optimizer, layout, **kwargs)
    accumulate = make_sharded_accumulate(layout)

    def train_step(state: TrainState, batches: Dict[str, Any], seed: int):
        acc_g = acc_ss = None
        task_logs = {}
        for name, gs in grad_steps.items():
            g, ss, logging = gs(state.params, state.step, batches[name], seed)
            task_logs[name] = logging
            acc_g, acc_ss = (g, ss) if acc_g is None else accumulate(acc_g, acc_ss, g, ss)
        state, metrics = apply_step(state, acc_g, acc_ss)
        out = dict(metrics)
        out["tasks"] = task_logs
        return state, out

    return train_step


def make_sharded_accumulate(layout: Layout) -> Callable:
    """(acc_g, acc_ss, g, ss) -> (acc_g, acc_ss): in place on the pieces."""

    def add(acc_g, acc_ss, g, ss):
        torch._foreach_add_(acc_g, g)
        return acc_g, acc_ss + ss

    return add


def put_batch(batch: Any, mesh: Mesh, update_freq: int = 1, local: bool = False) -> Any:
    """This rank's rows of a global host batch, on its device: dim 0 of
    every array (dim 1 under a leading microbatch axis, ``update_freq >
    1``) split over data x fsdp. ``local``: the batch already holds only
    this rank's rows (each rank read its own data shard)."""
    from ofasys_torch.utils.pytree import sample_to_device

    def rows(x, dim):
        if local or not isinstance(x, torch.Tensor) or x.dim() <= dim:
            return x
        r = batch_rows(mesh, x.shape[dim])
        return x.narrow(dim, r.start, r.stop - r.start)

    dim = 1 if update_freq > 1 else 0
    return sample_to_device(_map_arrays(batch, lambda x: rows(x, dim)), mesh.device)


def _map_arrays(tree, fn):
    import dataclasses

    import numpy as np

    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_arrays(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, np.ndarray) and tree.dtype != object:
        return fn(torch.from_numpy(np.ascontiguousarray(tree))).numpy()
    return fn(tree)
