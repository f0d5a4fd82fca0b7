"""GPipe pipeline parallelism over the ``pipe`` mesh axis (counterpart of
ofasys_tpu/parallel/pipeline.py).

The layers of a stack are split over S stages (stage s holds layers
[s * L/S, (s + 1) * L/S)); the batch splits into ``n_micro`` microbatches
that stream through the stages: stage 0 takes microbatch m from the input,
stage s > 0 receives it from stage s - 1, runs its layers and sends the
result on; the last stage's outputs are broadcast to every stage, whose
following computation is replicated. The backward runs the reverse
schedule: the last stage takes the cotangent of each microbatch from the
caller, every stage back-propagates through its own layers microbatch by
microbatch, last first, and sends the input's cotangent to the stage before.

It is one autograd function a rank: the forward builds each microbatch's
graph of the local layers on detached inputs, the backward takes
``torch.autograd.grad`` through them, so the stage's parameters, and the
side inputs (per-microbatch ``micro_args`` and shared ``bcast_args``
tensors, which every stage reads), get their gradients from the one
backward of the step. Side-input gradients and the input's are summed over
the stages, since the computation that made them is replicated there.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ofasys_torch.parallel import distributed as D

PIPE_AXIS = "pipe"


def _flatten(tree) -> Tuple[List[Any], Callable]:
    """Leaves of a tuple/list/dict tree (None kept) and its rebuilder."""
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        leaves = [x for p, _ in parts for x in p]
        sizes = [len(p) for p, _ in parts]

        def build(vals):
            out, i = [], 0
            for (_, b), n in zip(parts, sizes):
                out.append(b(vals[i:i + n]))
                i += n
            return type(tree)(out)
        return leaves, build
    if isinstance(tree, dict):
        keys = list(tree)
        leaves, build = _flatten([tree[k] for k in keys])
        return leaves, lambda vals: dict(zip(keys, build(vals)))
    return [tree], lambda vals: vals[0]


def stage_layers(n_layers: int, mesh, axis: str = PIPE_AXIS) -> range:
    """The global indices of this rank's stage's layers."""
    S = mesh.size(axis)
    if n_layers % S != 0:
        raise ValueError(f"pipeline: {n_layers} layers not divisible by {S} stages")
    per = n_layers // S
    s = mesh.index(axis)
    return range(s * per, (s + 1) * per)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *inputs):
        mesh, axis, layers, layer_apply, n_micro, n_m, m_build, b_build, n_b = plan
        group = mesh.group(axis)
        S, s = mesh.size(axis), mesh.index(axis)
        micro_in, bcast_in = inputs[:n_m], inputs[n_m:n_m + n_b]
        params = inputs[n_m + n_b:]
        B = x.shape[0]
        mb = B // n_micro
        with torch.enable_grad():
            bcast = [None if t is None else t.detach().requires_grad_(t.requires_grad) for t in bcast_in]
            bcast_args = b_build(bcast)
            runs, outs, pending = [], [], []
            for m in range(n_micro):
                if s == 0:
                    x_in = x[m * mb:(m + 1) * mb].detach()
                else:
                    x_in = D.recv(x[:mb], s - 1, group)
                x_in.requires_grad_(x.requires_grad or s > 0)
                mm = [None if t is None else t[m * mb:(m + 1) * mb].detach().requires_grad_(t.requires_grad)
                      for t in micro_in]
                h = x_in
                for gi in layers:
                    h = layer_apply(gi, m, h, m_build(mm), bcast_args)
                runs.append((x_in, mm, h))
                if s < S - 1:
                    pending.append(D.send(h, s + 1, group))
                else:
                    outs.append(h.detach())
            for req, _ in pending:
                req.wait()
        y = torch.cat(outs).to(x.dtype) if s == S - 1 else torch.empty_like(x)
        D.broadcast(y, mesh.global_rank(**{axis: S - 1}), group)
        ctx.plan = plan
        ctx.runs, ctx.bcast = runs, bcast
        ctx.params = params
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, gy):
        mesh, axis, layers, layer_apply, n_micro, n_m, m_build, b_build, n_b = ctx.plan
        group = mesh.group(axis)
        S, s = mesh.size(axis), mesh.index(axis)
        shape, dtype, device = ctx.x_meta
        mb = shape[0] // n_micro
        params = list(ctx.params)
        bcast = [t for t in ctx.bcast if t is not None and t.requires_grad]
        g_params = [None] * len(params)
        g_bcast = [None] * len(bcast)
        g_x = torch.zeros(shape, dtype=dtype, device=device)
        g_micro: List[List[Optional[torch.Tensor]]] = [[None] * n_micro for _ in range(n_m)]
        pending = []
        for m in reversed(range(n_micro)):
            x_in, mm, h = ctx.runs[m]
            g = gy[m * mb:(m + 1) * mb].contiguous() if s == S - 1 else D.recv(h.detach(), s + 1, group)
            mm_req = [t for t in mm if t is not None and t.requires_grad]
            wrt = ([x_in] if x_in.requires_grad else []) + mm_req + bcast + [p for p in params if p.requires_grad]
            grads = list(torch.autograd.grad(h, wrt, g.to(h.dtype), allow_unused=True))
            gx_in = grads.pop(0) if x_in.requires_grad else None
            if gx_in is None:
                gx_in = torch.zeros_like(x_in)
            it = iter(grads)
            for i, t in enumerate(mm):
                if t is not None and t.requires_grad:
                    g_micro[i][m] = next(it)
            for i in range(len(bcast)):
                gb = next(it)
                if gb is not None:
                    g_bcast[i] = gb if g_bcast[i] is None else g_bcast[i] + gb
            for i, p in enumerate(params):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None else g_params[i] + gp
            if s > 0:
                pending.append(D.send(gx_in, s - 1, group))
            else:
                g_x[m * mb:(m + 1) * mb] = gx_in
        for req, _ in pending:
            req.wait()
        # the input and the side inputs are replicated over the stages
        D.all_reduce(g_x, group)
        out_micro = []
        for i, t in enumerate(ctx.runs[0][1]):
            if t is None or not t.requires_grad:
                out_micro.append(None)
                continue
            parts = [gm if gm is not None else torch.zeros_like(ctx.runs[m][1][i])
                     for m, gm in enumerate(g_micro[i])]
            out_micro.append(D.all_reduce(torch.cat(parts).contiguous(), group))
        out_bcast, j = [], 0
        for t in ctx.bcast:
            if t is None or not t.requires_grad:
                out_bcast.append(None)
                continue
            gb = g_bcast[j] if g_bcast[j] is not None else torch.zeros_like(t)
            out_bcast.append(D.all_reduce(gb.contiguous(), group))
            j += 1
        ctx.runs = ctx.bcast = None
        return (None, g_x, *out_micro, *out_bcast, *g_params)


def pipeline_stack(
    mesh,
    layer_apply: Callable,       # (global_layer_idx, micro_idx, x_mb, micro_mb, bcast) -> x_mb
    n_layers: int,
    params_of: Callable,         # global_layer_idx -> the layer's parameters
    x: torch.Tensor,             # (B, ...) activations, batch-leading
    micro_args: Any = None,      # tree of (B, ...) tensors split with the batch (None leaves ok)
    bcast_args: Any = None,      # tree of tensors every stage reads whole (None leaves ok)
    n_micro: int = 0,
    axis: str = PIPE_AXIS,
) -> torch.Tensor:
    """Run ``n_layers`` layers as an S-stage GPipe pipeline; the same as

        for i in range(n_layers): x = layer_apply(i, 0, x, micro_args, bcast_args)

    with the layers split over ``axis`` and ``n_micro`` (default S)
    microbatches streamed through the stages. S == 1 is that loop."""
    S = mesh.size(axis)
    if S == 1:
        for i in range(n_layers):
            x = layer_apply(i, 0, x, micro_args, bcast_args)
        return x
    layers = stage_layers(n_layers, mesh, axis)
    B = x.shape[0]
    n_micro = n_micro or S
    if B % n_micro != 0:
        raise ValueError(f"pipeline: batch {B} not divisible by {n_micro} microbatches")
    m_leaves, m_build = _flatten(micro_args)
    b_leaves, b_build = _flatten(bcast_args)
    params: List[torch.Tensor] = [p for gi in layers for p in params_of(gi)]
    plan = (mesh, axis, layers, layer_apply, n_micro, len(m_leaves), m_build, b_build, len(b_leaves))
    return _Pipeline.apply(plan, x, *m_leaves, *b_leaves, *params)


def stage_params(names: Sequence[str], n_layers: int, prefix: str, mesh, axis: str = PIPE_AXIS) -> List[bool]:
    """For each parameter name, whether this stage holds it: a parameter of
    ``{prefix}layers_{i}.`` belongs to the stage of layer i, any other to
    every stage."""
    if mesh.size(axis) == 1:
        return [True] * len(names)
    own = set(stage_layers(n_layers, mesh, axis))
    out = []
    for n in names:
        if n.startswith(prefix + "layers_"):
            i = int(n[len(prefix) + len("layers_"):].split(".", 1)[0])
            out.append(i in own)
        else:
            out.append(True)
    return out
