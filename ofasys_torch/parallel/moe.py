"""Mixture-of-experts FFN with expert parallelism (counterpart of
ofasys_tpu/parallel/moe.py): switch-style top-1 routing with capacity
clipping; experts split over the mesh 'expert' axis, capacity buffers
exchanged both ways with ``all_to_all``.

The products are plain torch (einsum), as in ofasys_tpu, where they run
outside any Pallas kernel. ``moe_ffn_dense`` is the one-rank path,
``moe_ffn_sharded`` the expert-parallel one: the tokens, replicated over
the expert group, are split over it; each rank routes its share, sends
every expert's capacity buffer to the expert's owner, runs its own experts
on the buffers of every source, sends the results back and combines them;
the outputs are gathered back to every rank. Expert e lives on rank
e // (E / ep) as its local expert e % (E / ep).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ofasys_torch.parallel.distributed import diff_all_to_all, enter, exit, gather, scatter


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (the tanh approximation), the functions'
    default activation as in ofasys_tpu; the model passes its own."""
    return F.gelu(x, approximate="tanh")


def top1_routing(logits: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch routing of (N, E) router logits: (expert_idx (N,), gate (N,),
    slot (N,)), slot the token's position in its expert's capacity buffer
    (>= capacity means dropped)."""
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, logits.shape[-1]).to(torch.int32)
    slot = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    return expert_idx, gate, slot


def aux_load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch-transformer load-balancing loss."""
    E = logits.shape[-1]
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = F.one_hot(expert_idx, E).float().mean(dim=0)
    return E * torch.sum(me * ce)


def _dispatch(x: torch.Tensor, router_w: torch.Tensor, E: int, capacity: int):
    logits = x.float() @ router_w.float()
    expert_idx, gate, slot = top1_routing(logits, capacity)
    keep = slot < capacity
    disp = (F.one_hot(expert_idx, E).to(x.dtype)[:, :, None]
            * F.one_hot(torch.where(keep, slot, capacity), capacity + 1).to(x.dtype)[:, None, :capacity])
    return logits, expert_idx, gate, disp                     # disp (N, E, C)


def moe_ffn_dense(
    x: torch.Tensor,            # (N, D)
    router_w: torch.Tensor,     # (D, E)
    w1: torch.Tensor,           # (E, D, H)
    w2: torch.Tensor,           # (E, H, D)
    capacity_factor: float = 1.25,
    activation: Callable = gelu_tanh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-rank MoE by capacity-buffer einsum dispatch: (out (N, D), aux)."""
    N, D = x.shape
    E = router_w.shape[-1]
    capacity = max(int(capacity_factor * N / E), 1)
    logits, expert_idx, gate, disp = _dispatch(x, router_w, E, capacity)
    xs = torch.einsum("nd,nec->ecd", x, disp)                              # (E, C, D)
    h = activation(torch.einsum("ecd,edh->ech", xs, w1.to(x.dtype)))
    ys = torch.einsum("ech,ehd->ecd", h, w2.to(x.dtype))                   # (E, C, D)
    out = torch.einsum("ecd,nec->nd", ys, disp) * gate.to(x.dtype)[:, None]
    return out, aux_load_balance_loss(logits, expert_idx)


def moe_ffn_sharded(
    x: torch.Tensor,            # (N, D) tokens, the same on every rank of the expert group
    router_w: torch.Tensor,     # (D, E), replicated
    w1: torch.Tensor,           # (E / ep, D, H) this rank's experts
    w2: torch.Tensor,           # (E / ep, H, D)
    mesh,
    capacity_factor: float = 1.25,
    activation: Callable = gelu_tanh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over the 'expert' axis: (out (N, D), aux), both
    replicated over the group; each rank routes N / ep tokens with a
    capacity of ``capacity_factor * (N / ep) / E`` per expert."""
    group = mesh.group("expert")
    ep = mesh.size("expert")
    local_e = w1.shape[0]
    E = local_e * ep
    xs = scatter(x, 0, group)                                              # (N / ep, D)
    n_local, D = xs.shape
    capacity = max(int(capacity_factor * n_local / E), 1)
    logits, expert_idx, gate, disp = _dispatch(xs, enter(router_w, group), E, capacity)
    buf = torch.einsum("nd,nec->ecd", xs, disp)                            # (E, C, D)
    # expert e = owner * local_e + l: chunk `owner` goes to its rank
    buf = diff_all_to_all(buf.reshape(ep, local_e, capacity, D), group)    # (src, l, C, D)
    buf = buf.transpose(0, 1).reshape(local_e, ep * capacity, D)
    h = activation(torch.einsum("ecd,edh->ech", buf, w1.to(xs.dtype)))
    ys = torch.einsum("ech,ehd->ecd", h, w2.to(xs.dtype))                  # (l, src * C, D)
    ys = ys.reshape(local_e, ep, capacity, D).transpose(0, 1).contiguous()
    ys = diff_all_to_all(ys, group).reshape(E, capacity, D)                # (owner * l, C, D)
    out = torch.einsum("ecd,nec->nd", ys, disp) * gate.to(xs.dtype)[:, None]
    aux = exit(aux_load_balance_loss(logits, expert_idx), group) / ep
    return gather(out, 0, group), aux
