"""Gaussian diffusion (counterpart of ofasys_tpu/model/diffusion.py).

Epsilon- and x0-prediction, linear / cosine / scaled-linear beta
schedules, min-SNR loss weighting, and DDIM sampling (deterministic at
eta = 0, stochastic above) with optional classifier-free guidance. The
schedule is computed in float64 numpy and held in fp32, as in ofasys_tpu;
all sampling math is fp32. The roots of ``alphas_bar`` are tabulated once in
numpy fp32 (correctly rounded, as XLA's fp32 sqrt is; torch's vectorised
fp32 sqrt on some CPUs is one ulp off) and gathered where ofasys_tpu takes
the root of a gathered value. Random draws come from the caller
(``noise_fn``), so the caller owns the ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def make_betas(schedule: str, num_steps: int) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(1e-4, 0.02, num_steps, dtype=np.float64)
    if schedule == "cosine":
        s = 0.008
        t = np.linspace(0, num_steps, num_steps + 1) / num_steps
        f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
        betas = 1.0 - f[1:] / f[:-1]
        return np.clip(betas, 0, 0.999)
    if schedule == "scaled_linear":  # stable-diffusion style
        return np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_steps, dtype=np.float64) ** 2
    raise ValueError(f"unknown beta schedule {schedule!r}")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    num_steps: int = 1000
    schedule: str = "cosine"
    prediction_type: str = "epsilon"    # 'epsilon' | 'sample'
    snr_gamma: Optional[float] = None   # min-SNR loss weighting

    def __post_init__(self):
        betas = make_betas(self.schedule, self.num_steps)
        alphas_bar = np.cumprod(1.0 - betas)
        object.__setattr__(self, "betas", betas.astype(np.float32))
        ab = alphas_bar.astype(np.float32)
        object.__setattr__(self, "alphas_bar", ab)
        # sqrt(ab), sqrt(1 - ab) with the subtraction in fp32, sqrt(max(ab, 1e-8))
        object.__setattr__(self, "tables", {
            "ab": ab,
            "sqrt_ab": np.sqrt(ab),
            "sqrt_1m_ab": np.sqrt(np.float32(1) - ab),
            "sqrt_ab_floor": np.sqrt(np.maximum(ab, np.float32(1e-8))),
        })
        object.__setattr__(self, "_on_device", {})

    def _gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """tables[name][t] (fp32) on t's device."""
        on_device: Dict[Tuple[str, torch.device], torch.Tensor] = self._on_device
        key = (name, t.device)
        if key not in on_device:
            on_device[key] = torch.from_numpy(self.tables[name]).to(t.device)
        return on_device[key][t.long()]

    # ------------------------------------------------------------- training
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(a_bar_t) x0 + sqrt(1 - a_bar_t) eps; t: (B,) int."""
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return (self._gather("sqrt_ab", t).reshape(shape) * x0
                + self._gather("sqrt_1m_ab", t).reshape(shape) * noise)

    def training_target(self, x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return noise if self.prediction_type == "epsilon" else x0

    def loss_weight(self, t: torch.Tensor) -> torch.Tensor:
        """Min-SNR-gamma weighting (Hang et al.); 1.0 when disabled."""
        if self.snr_gamma is None:
            return torch.ones(t.shape, dtype=torch.float32, device=t.device)
        ab = self._gather("ab", t)
        snr = ab / torch.clamp(1 - ab, min=1e-8)
        if self.prediction_type == "epsilon":
            return torch.clamp(self.snr_gamma / torch.clamp(snr, min=1e-8), max=1.0)
        return torch.clamp(snr, max=self.snr_gamma) / torch.clamp(snr, min=1e-8)

    def to_x0(self, x_t: torch.Tensor, t: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        if self.prediction_type == "sample":
            return pred
        shape = (-1,) + (1,) * (x_t.dim() - 1)
        return ((x_t - self._gather("sqrt_1m_ab", t).reshape(shape) * pred)
                / self._gather("sqrt_ab_floor", t).reshape(shape))

    # ------------------------------------------------------------- sampling
    def ddim_sample(
        self,
        denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (x_t, t (B,)) -> pred
        shape: Tuple[int, ...],
        noise_fn: Callable[[Tuple[int, ...]], torch.Tensor],   # shape -> fp32 N(0, 1) draws
        num_inference_steps: int = 50,
        eta: float = 0.0,
        guidance_weight: float = 0.0,
        uncond_denoise_fn: Optional[Callable] = None,
        clamp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """DDIM from x_T = noise_fn(shape): one denoiser call a step, with
        classifier-free guidance when ``uncond_denoise_fn`` is given. The
        per-step scalars are fp32 numpy values (IEEE-rounded, as ofasys_tpu's
        fp32 scalars); a step draws fresh noise only where eta > 0."""
        # from num_steps - 1 down to 0; each step's successor, -1 after the last
        steps = np.linspace(self.num_steps - 1, 0, num_inference_steps).round().astype(np.int32)
        steps_next = np.concatenate([steps[1:], [-1]]).astype(np.int32)
        ab_all, sqrt_ab = self.alphas_bar, self.tables["sqrt_ab"]
        one, tiny = np.float32(1.0), np.float32(1e-8)
        x = noise_fn(shape)
        for t, t_next in zip(steps.tolist(), steps_next.tolist()):
            tb = torch.full((shape[0],), t, dtype=torch.int32, device=x.device)
            pred = denoise_fn(x, tb)
            if guidance_weight > 0 and uncond_denoise_fn is not None:
                pred_u = uncond_denoise_fn(x, tb)
                pred = pred_u + (1.0 + guidance_weight) * (pred - pred_u)
            x0 = self.to_x0(x, tb, pred)
            if clamp_fn is not None:
                x0 = clamp_fn(x0)
            ab_t = ab_all[t]
            ab_next = ab_all[max(t_next, 0)] if t_next >= 0 else one
            sqrt_1m_t = np.sqrt(max(one - ab_t, tiny))
            sigma = np.float32(eta) * np.sqrt(
                max((one - ab_next) / max(one - ab_t, tiny), np.float32(0))
                * max(one - ab_t / max(ab_next, tiny), np.float32(0)))
            c_dir = np.sqrt(max(one - ab_next - sigma * sigma, np.float32(0)))
            sqrt_ab_next = sqrt_ab[t_next] if t_next >= 0 else one
            eps = (x - float(sqrt_ab[t]) * x0) / float(sqrt_1m_t)
            x = float(sqrt_ab_next) * x0 + float(c_dir) * eps
            if eta > 0:
                x = x + float(sigma) * noise_fn(shape)
        return x
