"""Diffusion training criterion (counterpart of
ofasys_tpu/engine/criterion/diffusion_loss.py): corrupt the target slot's
features with ``q_sample`` at a random timestep, run the decoder with full
context, and take the masked L1 or L2 distance to the prediction target
(with min-SNR weighting), in fp32.

The timesteps and the noise come from :meth:`DiffusionCriterion.draw`,
which draws them from the step's ``torch.Generator``; ofasys_tpu draws
them from ``jax.random``, so the numbers differ.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.engine.criterion.base import BaseCriterion, CriterionConfig
from ofasys_torch.model.diffusion import GaussianDiffusion


@dataclass
class DiffusionCriterionConfig(CriterionConfig):
    num_steps: int = 1000
    schedule: str = "cosine"
    prediction_type: str = "epsilon"
    loss_type: str = "l1"          # 'l1' | 'l2'
    snr_gamma: Optional[float] = None


@register_config("ofasys.criterion", "diffusion_criterion", DiffusionCriterionConfig)
class DiffusionCriterion(BaseCriterion):
    def __init__(self, cfg: DiffusionCriterionConfig, pad_id: int = 1):
        super().__init__(cfg, pad_id)
        self.diffusion = GaussianDiffusion(
            num_steps=cfg.num_steps, schedule=cfg.schedule,
            prediction_type=cfg.prediction_type, snr_gamma=cfg.snr_gamma,
        )

    def draw(self, sample, x0: torch.Tensor,
             generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's random timesteps (B,) in [0, num_steps) and fp32
        noise shaped like ``x0``."""
        t = torch.randint(0, self.cfg.num_steps, (x0.shape[0],), generator=generator,
                          device=x0.device)
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=torch.float32)
        return t, noise

    def __call__(self, model, sample, generator=None, train: bool = True):
        slots = sample["net_input"]["slots"]
        tgt_idx = max(i for i, s in enumerate(slots) if not s.is_src)
        tgt = slots[tgt_idx]
        x0 = tgt.value["value"].float()                        # (B, T, F)
        masks = tgt.value.get("masks")                          # (B, T) True = valid
        B = x0.shape[0]

        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(0)
        t, noise = self.draw(sample, x0, generator)
        x_t = self.diffusion.q_sample(x0, t, noise)

        noised = dataclasses.replace(tgt, value={**tgt.value, "value": x_t, "noise_level": t})
        new_slots = list(slots)
        new_slots[tgt_idx] = noised
        pred, _ = model.apply_train(new_slots, deterministic=not train, generator=generator,
                                    full_context=True)

        target = self.diffusion.training_target(x0, noise)
        err = (pred - target).abs() if self.cfg.loss_type == "l1" else (pred - target) ** 2
        err = err * self.diffusion.loss_weight(t)[:, None, None]
        if masks is not None:
            masks = masks.bool()
            err = torch.where(masks[:, :, None], err, torch.zeros((), device=err.device))
            ntokens = masks.sum()
        else:
            ntokens = torch.tensor(x0.shape[0] * x0.shape[1], device=x0.device)
        loss = err.sum() / x0.shape[-1]
        sample_size = ntokens.float()
        logging = {
            "loss": loss.detach(),
            "ntokens": ntokens,
            "nsentences": B,
            "sample_size": sample_size,
        }
        return loss, sample_size, logging
