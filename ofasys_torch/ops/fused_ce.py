"""Chunked-vocab fused cross-entropy statistics (counterpart of
ofasys_tpu/ops/fused_ce.py).

The label-smoothed criterion reads the (N, V) logits only through three
per-row reductions: the logsumexp, the target logit z_t and the row sum.
When the logits are the tied projection ``x @ W^T``, :func:`chunked_ce_stats`
computes the three over vocabulary chunks, and its backward recomputes each
chunk's logits, so that neither the (N, V) logits nor their gradient ever
exists. Each chunk's product is a plain GEMM in the compute dtype, as
ofasys_tpu computes it (a ``lax.scan`` of dots outside any Pallas kernel).

Numerics follow the unfused criterion: each chunk's logits are rounded to
the compute dtype before the fp32 reductions, as the projection's output is.
In the backward a chunk's logit gradient is rounded to the compute dtype
before its two products (as ofasys_tpu's), and each product's output is in
the compute dtype (ofasys_tpu's are fp32), summed over chunks in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch


def pick_chunks(V: int, target: int = 4096) -> Optional[int]:
    """Number of chunks C > 1 with V % C == 0, V / C a multiple of 128 and
    V / C closest to ``target`` (the smallest such C on a tie); None when V
    has no such divisor. 50,048 symbols: 17 chunks of 2,944."""
    best = None
    for C in range(2, 65):
        if V % C or (V // C) % 128:
            continue
        if best is None or abs(V // C - target) < abs(V // best - target):
            best = C
    return best


def _chunk_logits(xc: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, Vc) logits of one chunk in ``dtype``, read as fp32."""
    return (xc @ w.to(dtype).t()).to(dtype).float()


class ChunkedCEStats(torch.autograd.Function):
    """(lse, z_t, zsum) over the virtual logits ``x2 @ emb.T``, chunk by chunk."""

    @staticmethod
    def forward(ctx, x2, emb, tgt, n_chunks: int, compute_dtype: torch.dtype):
        N, E = x2.shape
        V = emb.shape[0]
        Vc = V // n_chunks
        xc = x2.to(compute_dtype)
        dev = x2.device
        m = torch.full((N,), float("-inf"), device=dev)
        l = torch.zeros((N,), device=dev)
        z_t = torch.zeros((N,), device=dev)
        zsum = torch.zeros((N,), device=dev)
        for c in range(n_chunks):
            s = _chunk_logits(xc, emb[c * Vc:(c + 1) * Vc], compute_dtype)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = tgt - c * Vc
            hit = (local >= 0) & (local < Vc)
            got = torch.gather(s, 1, local.clamp(0, Vc - 1)[:, None])[:, 0]
            z_t = torch.where(hit, got, z_t)
            zsum = zsum + s.sum(dim=-1)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(x2, emb, tgt, lse)
        ctx.args = (n_chunks, compute_dtype)
        return lse, z_t, zsum

    @staticmethod
    def backward(ctx, g_lse, g_zt, g_zsum):
        """ds = g_lse * p + g_zt * 1[v = tgt] + g_zsum per chunk; each chunk's
        ds feeds dx (summed in fp32) and its rows of d emb."""
        x2, emb, tgt, lse = ctx.saved_tensors
        n_chunks, cdt = ctx.args
        N, E = x2.shape
        V = emb.shape[0]
        Vc = V // n_chunks
        zero = torch.zeros((N,), device=x2.device)
        g_lse, g_zt, g_zsum = (zero if g is None else g.float() for g in (g_lse, g_zt, g_zsum))
        xc = x2.to(cdt)
        cols = torch.arange(Vc, device=x2.device)
        dx = torch.zeros((N, E), device=x2.device)
        dw = torch.empty((V, E), dtype=torch.float32, device=x2.device)
        for c in range(n_chunks):
            w = emb[c * Vc:(c + 1) * Vc].to(cdt)
            s = _chunk_logits(xc, w, cdt)
            p = torch.exp(s - lse[:, None])
            local = tgt - c * Vc
            onehot = (cols[None, :] == local[:, None]) & ((local >= 0) & (local < Vc))[:, None]
            ds = (g_lse[:, None] * p + torch.where(onehot, g_zt[:, None], 0.0)
                  + g_zsum[:, None]).to(cdt)
            dx += (ds @ w).float()
            dw[c * Vc:(c + 1) * Vc] = (ds.t() @ xc).float()
        return dx.to(x2.dtype), dw.to(emb.dtype), None, None, None


def chunked_ce_stats(x2: torch.Tensor, emb: torch.Tensor, tgt: torch.Tensor, n_chunks: int,
                     compute_dtype: torch.dtype = torch.bfloat16):
    """x2 (N, E) hidden states, emb (V, E) the tied table (V % n_chunks ==
    0), tgt (N,) target ids -> fp32 (N,) each: the row's logsumexp, the
    target logit and the row sum of the logits ``x2 @ emb.T`` in
    ``compute_dtype``. Gradients flow to x2 and emb."""
    return ChunkedCEStats.apply(x2, emb, tgt.long(), n_chunks, compute_dtype)
