"""Plain attention (counterpart of ofasys_tpu/ops/attention.py).

Conventions: q (B, Tq, H, D); k/v (B, Tk, H, D); bias additive,
broadcastable to (B, H, Tq, Tk); mask bool broadcastable to
(B, 1|H, Tq, Tk) with True = attend.
"""

from __future__ import annotations

from typing import Optional

import torch

# Large negative used for masking. Not -inf: fully-masked query rows (pad
# queries) would produce NaNs.
MASK_VALUE = -1e9


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype: Optional[torch.dtype] = None,
    logits_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Batched multi-head attention with additive bias.

    Scores are the fp32 products of the q/k values (an fp32 matmul of the
    upcast operands, as ``preferred_element_type=float32`` gives in JAX);
    softmax is fp32; probabilities are cast to the output dtype for p·V.
    ``logits_dtype`` (the ``attn_logits='compute'`` policy) rounds the
    finished scores to that dtype before the fp32 softmax. With
    ``dropout_rate > 0`` and a ``generator``, the fp32 probabilities are
    dropped as ofasys_tpu drops them (:func:`dropout`).
    """
    out_dtype = dtype or q.dtype
    qh = q.permute(0, 2, 1, 3).float()                      # (B, H, Tq, D)
    kh = k.permute(0, 2, 3, 1).float()                      # (B, H, D, Tk)
    logits = torch.matmul(qh, kh) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), MASK_VALUE, device=logits.device))
    if logits_dtype is not None and logits_dtype != torch.float32:
        logits = logits.to(logits_dtype).float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        probs = dropout(probs, dropout_rate, generator)
    probs = probs.to(out_dtype)
    vh = v.permute(0, 2, 1, 3).to(out_dtype)                # (B, H, Tk, D)
    return torch.matmul(probs, vh).permute(0, 2, 1, 3)      # (B, Tq, H, D)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shape: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    (a Bernoulli draw from ``generator``, which must live on x's device) and
    scale the kept ones by ``1 / (1 - rate)``. ``shape``
    broadcasts one draw over the rest (DropPath draws one per sample). A
    rate of 0 or no generator (deterministic) returns x."""
    if rate <= 0.0 or generator is None:
        return x
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(shape or x.shape, generator=generator, device=x.device) < keep_prob
    # JAX divides by the keep probability rounded to x's dtype (a weakly
    # typed scalar takes the array's dtype)
    scale = float(torch.tensor(keep_prob, dtype=x.dtype))
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_mask(tq: int, tk: int, device=None) -> torch.Tensor:
    """(1, 1, tq, tk) lower-triangular keep-mask; offset aligns the last query
    step with the last key step (incremental decoding slices)."""
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tk, device=device)[None, :]
    return (j <= i + (tk - tq))[None, None]


def combine_masks(*masks):
    """AND together keep-masks, ignoring Nones. Returns None if all None."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else torch.logical_and(out, m)
    return out
