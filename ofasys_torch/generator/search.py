"""Logit transforms of the decode loop (counterpart of part of
ofasys_tpu/generator/search.py: ``apply_min_len``, ``apply_constraint_range``,
``apply_vocab_mask``, ``block_repeat_ngrams`` and ``length_penalty``).
Tries, lexical constraints, diverse search and sampling filters wait for a
later slice."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def apply_min_len(log_probs: torch.Tensor, step: int, min_len: int, eos: int) -> torch.Tensor:
    """Disallow EOS before min_len steps."""
    if step < min_len:
        log_probs = log_probs.clone()
        log_probs[..., eos] = NEG_INF
    return log_probs


def apply_constraint_range(log_probs: torch.Tensor, start: int, end: int, eos: int) -> torch.Tensor:
    """Allow only [start, end) plus EOS (the bin or code sub-vocabulary of a
    BOX or image target)."""
    ids = torch.arange(log_probs.shape[-1], device=log_probs.device)
    allowed = ((ids >= start) & (ids < end)) | (ids == eos)
    return apply_vocab_mask(log_probs, allowed)


def apply_vocab_mask(log_probs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask: bool (..., V), True = allowed."""
    return torch.where(mask, log_probs, torch.full((), NEG_INF, dtype=log_probs.dtype,
                                                   device=log_probs.device))


def block_repeat_ngrams(
    log_probs: torch.Tensor,     # (N, V)
    tokens: torch.Tensor,        # (N, T) generated so far (garbage beyond step)
    step: int,                   # next position to be generated
    ngram: int,
) -> torch.Tensor:
    """Ban tokens completing an already-seen n-gram: compare every
    historical (n-1)-window to the current suffix and set NEG_INF at the
    tokens that followed matching windows."""
    k = ngram - 1
    if ngram <= 0 or step < k:
        return log_probs
    N, T = tokens.shape
    P = T - k
    nxt = tokens[:, k:]                                            # (N, P) token after each window
    if k > 0:
        suffix = tokens[:, step - k:step]                          # (N, k)
        windows = tokens.unfold(1, k, 1)[:, :P]                    # (N, P, k)
        match = (windows == suffix[:, None, :]).all(dim=-1)        # (N, P)
    else:
        match = torch.ones((N, P), dtype=torch.bool, device=tokens.device)
    # only windows fully inside the generated region: p + k < step
    idx = torch.arange(P, device=tokens.device)
    match = match & ((idx[None, :] + k) < step)
    rows, cols = match.nonzero(as_tuple=True)
    out = log_probs.clone()
    out[rows, nxt[rows, cols]] = NEG_INF
    return out


def length_penalty(length: int, alpha: float) -> float:
    """fairseq-style: score / len**alpha, computed in fp32."""
    return float(torch.tensor(float(max(length, 1)), dtype=torch.float32) ** alpha)
