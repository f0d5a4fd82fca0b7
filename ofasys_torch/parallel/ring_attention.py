"""Ring attention: sequence parallelism over the 'sequence' mesh axis
(counterpart of ofasys_tpu/parallel/ring_attention.py).

Each rank of the sequence group holds its block of Tq / n query rows and of
the keys and values. The K/V blocks travel around the ring with
``ppermute``; each step attends the local queries to the block in hand and
the partial results merge with their log-sum-exp (the flash combine), so a
rank never holds more than a (B, H, T/n, T/n) block of scores.

The block runs kernel B3 through ``ops.flash_attention.flash_attention_with_lse``
wherever the block passes the port's flash gate (CUDA tensors, Tk >= 256),
and the plain ``_block_attn`` elsewhere. The merge is written in autograd
ops over (out, lse) of every block, inside one autograd function a rank
(``_Ring``), so the backward is a ring as well: the lse cotangent goes into
``FlashAttentionFunction``'s backward (the one-pass flash backward, kernels
B4-dq, B4-dkv and B5), and the K/V gradients travel back to their owners
around the ring the other way. The
TPU's ``Tq % 16 == 0 and Tk % 128 == 0`` condition is not carried over: the
port's kernels take ragged tails.

Causal: rank i's queries (global rows [i * Tl, (i + 1) * Tl)) see key
blocks j <= i only. The block in hand at step s is j = (i - s) mod n: j == i
(step 0) runs the locally causal block, j < i the whole block, j > i is
skipped (no compute, only the ppermute).

Bias and mask keep their global key axis: the caller hands each rank its
bias rows (1|B, H, Tq/n, Tk), and the ring step's column block is sliced out
here; the (B, 1, 1, Tk) keep-mask is kept whole. Batch rows and heads are
this rank's already (the model splits them over data x fsdp and tensor), so
``ring_attention`` takes no batch or head axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ofasys_torch.ops.flash_attention import flash_attention_with_lse, flash_available, flash_supported
from ofasys_torch.parallel.distributed import ppermute

NEG_INF = -1e9


def _block_attn(q, k, v, scale, causal=False, bias=None, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain partial attention: (normalized out fp32 (B, Tq, H, D), lse
    (B, H, Tq)). bias: (1|B, H, Tq, Tk) additive, mask (B, 1, 1, Tk) bool
    keep, both already sliced to this ring block."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    neg = torch.full((), NEG_INF, device=s.device)
    if mask is not None:
        s = torch.where(mask, s, neg)
    if causal:
        Tq, Tk = s.shape[-2:]
        vis = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(vis, s, neg)
    m = s.amax(dim=-1)                                                     # (B, H, Tq)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)                              # (B, H, Tq)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)                  # (B, Tq, H, D)
    return o.float() / l.transpose(1, 2)[..., None], m + torch.log(l)


def _block_attn_flash(q, k, v, scale, causal=False, bias=None, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same contract through kernel B3 (``flash_attention_with_lse``) at
    the kernels' layout (B, T, H * D); the bias in bf16, the kernels' bias
    format (as ``ops.flash_attention.flash_attention`` rounds it)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bf = None
    if bias is not None:
        bias = bias.to(torch.bfloat16)
        bf = (bias[0].expand(H, Tq, Tk) if bias.shape[0] == 1
              else bias.expand(B, H, Tq, Tk).reshape(B * H, Tq, Tk)).contiguous()
    mf = None
    if mask is not None:
        mf = mask.to(torch.int8).expand(B, 1, 1, Tk).reshape(B, 1, Tk).contiguous()
    out, lse = flash_attention_with_lse(
        q.reshape(B, Tq, H * D).contiguous(), k.reshape(B, Tk, H * D).contiguous(),
        v.reshape(B, Tk, H * D).contiguous(), bf, mf, H, float(scale), bool(causal))
    return out.reshape(B, Tq, H, D).float(), lse


class _Ring(torch.autograd.Function):
    """The ring as one autograd function a rank, so that every rank runs
    its collectives in the same order whatever blocks it skips: the
    forward builds each step's block (and the merge) as a local graph on
    detached inputs while K/V travel the ring; the backward takes one
    ``torch.autograd.grad`` through that graph (the blocks' own backward:
    B4/B5 through ``FlashAttentionFunction``, the lse cotangent included),
    then runs the ring the other way, each rank adding its gradient for
    the block it held at step s to the sum travelling to that block's
    owner."""

    @staticmethod
    def forward(ctx, q, k, v, bias, plan):
        mesh, axis, block, scale, causal, mask = plan
        n, group, my = mesh.size(axis), mesh.group(axis), mesh.index(axis)
        Tk = k.shape[1]
        perm = [(i, (i + 1) % n) for i in range(n)]
        with torch.enable_grad():
            q_ = q.detach().requires_grad_(q.requires_grad)
            b_ = None if bias is None else bias.detach().requires_grad_(bias.requires_grad)
            held, o_acc, lse_acc = [], None, None
            k_cur, v_cur = k.detach(), v.detach()
            for s in range(n):
                j = (my - s) % n
                kk = k_cur.requires_grad_(k.requires_grad)
                vv = v_cur.requires_grad_(v.requires_grad)
                held.append((kk, vv))
                if not causal or j <= my:
                    b = None if b_ is None else b_[..., j * Tk:(j + 1) * Tk]
                    m = None if mask is None else mask[..., j * Tk:(j + 1) * Tk]
                    o_i, lse_i = block(q_, kk, vv, scale, causal=causal and j == my, bias=b, mask=m)
                    if o_acc is None:
                        o_acc, lse_acc = o_i, lse_i
                    else:
                        lse_new = torch.logaddexp(lse_acc, lse_i)
                        a_old = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
                        a_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
                        o_acc = o_acc * a_old + o_i * a_new
                        lse_acc = lse_new
                if s < n - 1:
                    k_cur = ppermute(k_cur.detach(), perm, group)
                    v_cur = ppermute(v_cur.detach(), perm, group)
            out = o_acc.to(q.dtype)
        ctx.plan, ctx.graph = plan, (q_, b_, held, out)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.plan[:2]
        n, group = mesh.size(axis), mesh.group(axis)
        q_, b_, held, out = ctx.graph
        items = [("q", q_), ("b", b_)] + [((kind, s), t) for s, kv in enumerate(held)
                                          for kind, t in zip("kv", kv)]
        req = [(key, t) for key, t in items if t is not None and t.requires_grad]
        grads = dict(zip([key for key, _ in req],
                         torch.autograd.grad(out, [t for _, t in req], g, allow_unused=True)))
        dq, db = grads.get("q"), grads.get("b")
        back = [(i, (i - 1) % n) for i in range(n)]
        dk = dv = None
        for s in reversed(range(n)):
            gk, gv = grads.get(("k", s)), grads.get(("v", s))
            gk = torch.zeros_like(held[s][0]) if gk is None else gk
            gv = torch.zeros_like(held[s][1]) if gv is None else gv
            dk = gk if dk is None else dk + gk
            dv = gv if dv is None else dv + gv
            if s > 0:
                dk = ppermute(dk.contiguous(), back, group)
                dv = ppermute(dv.contiguous(), back, group)
        ctx.graph = None
        return dq, dk, dv, db, None


def ring_attention(
    q: torch.Tensor,                 # (B, Tq/n, H, D) this rank's query block
    k: torch.Tensor,                 # (B, Tk/n, H, D)
    v: torch.Tensor,
    mesh,
    scale: float = 1.0,
    axis: str = "sequence",
    use_flash: Optional[bool] = None,
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,   # (1|B, H, Tq/n, Tk) this rank's bias rows
    mask: Optional[torch.Tensor] = None,   # bool keep (B, 1, 1, Tk), global keys
) -> torch.Tensor:
    """Attention over the ring; the output (B, Tq/n, H, D) in q's dtype.
    ``use_flash`` forces the inner block on or off; None takes B3 where the
    block passes the flash gate."""
    n = mesh.size(axis)
    group = mesh.group(axis)
    my = mesh.index(axis)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    flash = use_flash
    if flash is None:
        flash = flash_available(q.device) and flash_supported(Tq, Tk, D, 0.0)
    block = _block_attn_flash if flash else _block_attn
    return _Ring.apply(q, k, v, bias, (mesh, axis, block, scale, causal, mask))
