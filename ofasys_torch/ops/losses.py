"""Loss-side reductions over large vocabularies (counterpart of
ofasys_tpu/ops/losses.py)."""

from __future__ import annotations

import torch


def token_log_probs(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """log p(target token) per position: z_t - logsumexp(z), in fp32.

    logits: (..., V) in any float dtype; targets: (...) integer.
    Returns (...) fp32; differentiable."""
    V = logits.shape[-1]
    z = logits.reshape(-1, V)
    zf = z.float()
    zmax = zf.max(dim=-1, keepdim=True).values.detach()
    lse = zmax[:, 0] + torch.log(torch.exp(zf - zmax).sum(dim=-1))
    t = targets.reshape(-1).long()
    z_t = torch.gather(z, 1, t[:, None])[:, 0].float()
    return (z_t - lse).reshape(targets.shape)
