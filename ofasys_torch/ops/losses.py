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


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, (B,) fp32: optax's
    ``ctc_loss``, the forward algorithm that ofasys_tpu's speech_to_text
    criterion runs, step for step. Log-softmax inside; paddings (1.0 = pad,
    labels right-padded) instead of lengths; an impossible alignment (a
    label run longer than its frames) scores through ``log_epsilon``, a
    finite stand-in for log 0, so the loss never becomes inf.

    logits (B, T, K), logit_paddings (B, T), labels (B, N) int,
    label_paddings (B, N); differentiable in ``logits``."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    labellens = N - label_paddings.float().sum(dim=1).to(torch.long)
    # repeat[b, n] = 1 where label n equals label n + 1
    repeat = torch.zeros((B, N), dtype=torch.float32, device=logits.device)
    if N > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    logprobs_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]           # (T, B, 1)
    logprobs_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(B, T, N))
    logprobs_emit = logprobs_emit.transpose(0, 1)                                   # (T, B, N)
    pads = logit_paddings.float().transpose(0, 1)[..., None]                        # (T, B, 1)

    phi = torch.full((B, N + 1), log_epsilon, dtype=torch.float32, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=torch.float32, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    for t in range(T):
        phi_orig = phi
        # emit -> phi epsilon transition, except before a repeated label
        phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t]
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = phi + lp_phi
        # emit -> phi blank transition only before a repeated label
        next_phi = update_phi(next_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]
