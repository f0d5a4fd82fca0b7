"""Diffusion generator (counterpart of
ofasys_tpu/generator/diffusion_generator.py): encode the sources once,
then DDIM-sample the target slot's features with the full-context decoder
as the denoiser, ``clamp_fn`` (the motion preprocessor's ``clamp``) on each
step's x0 estimate.

The initial noise (and, at eta > 0, each step's noise) comes from
:meth:`DiffusionGenerator.noise`, which draws from a ``torch.Generator``
seeded with ``seed``; ofasys_tpu draws from ``jax.random``, so the numbers
differ.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ofasys_torch.generator.base import MotionOutput
from ofasys_torch.model.diffusion import GaussianDiffusion
from ofasys_torch.utils.pytree import SlotBatch, slots_to_device


class DiffusionGenerator:
    def __init__(
        self,
        model,                       # GeneralistModel
        num_steps: int = 1000,
        schedule: str = "cosine",
        prediction_type: str = "epsilon",
        num_inference_steps: int = 50,
        eta: float = 0.0,
        guidance_weight: float = 0.0,
        clamp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ):
        self.model = model
        self.diffusion = GaussianDiffusion(num_steps=num_steps, schedule=schedule,
                                           prediction_type=prediction_type)
        self.num_inference_steps = num_inference_steps
        self.eta = eta
        self.guidance_weight = guidance_weight
        self.clamp_fn = clamp_fn

    def noise(self, shape: Tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
        """fp32 N(0, 1) draws of ``shape`` on the generator's device."""
        return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)

    @torch.no_grad()
    def generate(self, sample: Dict[str, Any], seed: int = 0) -> List[MotionOutput]:
        """One MotionOutput per sample: its features at the frames its
        target mask keeps."""
        net = self.model.net
        device = net.device
        slots = sample["net_input"]["slots"]
        src = slots_to_device([s for s in slots if s.is_src], device)
        tgt = slots_to_device([SlotBatch.target_slot(slots)], device)[0]
        enc = net.encode(src)
        shape = tuple(tgt.value["value"].shape)
        generator = torch.Generator(device=device).manual_seed(seed)

        def denoise(x_t, t):
            noised = dataclasses.replace(tgt, value={**tgt.value, "value": x_t, "noise_level": t})
            pred, _ = net.decode_full([noised], enc, full_context=True)
            return pred.float()

        feats = self.diffusion.ddim_sample(
            denoise, shape, lambda s: self.noise(s, generator),
            num_inference_steps=self.num_inference_steps,
            eta=self.eta, guidance_weight=self.guidance_weight,
            clamp_fn=self.clamp_fn,
        ).cpu().numpy()
        masks = tgt.value.get("masks")
        masks = None if masks is None else masks.bool().cpu().numpy()
        return [MotionOutput(feature=f if masks is None else f[masks[b]])
                for b, f in enumerate(feats)]
