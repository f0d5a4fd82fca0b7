"""Motion 6D adaptor (counterpart of ofasys_tpu/adaptor/motion.py,
``motion_6d``): the continuous-feature adaptor of the diffusion decoder.

The diffusion timestep arrives in the slot value as ``noise_level`` (B,)
and enters as an fp32 sinusoidal embedding through ``time_mlp1`` / SiLU /
``time_mlp2``, added to every frame. The time branch always runs: without
a timestep, t = 0. ``forward_output`` projects hidden states to features
through ``out_proj_feat`` in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.model.transformer import Dense
from ofasys_torch.utils.pytree import SlotBatch


@dataclass
class Motion6dAdaptorConfig:
    feature_dim: int = 135      # 3 + 22 joints * 6
    time_embed_dim: int = 256


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) int timesteps -> (B, dim) fp32 sinusoidal features."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Motion6dAdaptor(BaseAdaptor):
    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype,
                 acfg: Optional[Motion6dAdaptorConfig] = None):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.acfg = acfg = acfg or Motion6dAdaptorConfig()
        E = self.embed_dim
        self.in_proj = Dense(acfg.feature_dim, E, dtype, cfg)
        self.time_mlp1 = Dense(acfg.time_embed_dim, E, dtype, cfg)
        self.time_mlp2 = Dense(E, E, dtype, cfg)
        self.embed_positions = nn.Embedding(cfg.max_target_positions + 2, E)
        self.out_proj_feat = Dense(E, acfg.feature_dim, torch.float32, cfg)

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        value = slot.value["value"].to(self.dtype)             # (B, T, F)
        masks = slot.value.get("masks")                        # (B, T) True = valid
        B, T, _ = value.shape
        x = self.in_proj(value)

        t = slot.value.get("noise_level")
        if t is None:
            t = torch.zeros((B,), dtype=torch.int32, device=value.device)
        te = sinusoidal_embedding(t, self.acfg.time_embed_dim)
        te = self.time_mlp2(F.silu(self.time_mlp1(te)))
        x = x + te[:, None, :]

        padding_mask = (torch.logical_not(masks.bool()) if masks is not None
                        else torch.zeros((B, T), dtype=torch.bool, device=value.device))
        positions = torch.arange(T, device=value.device)
        pos_embed = self.embed_positions.weight[positions][None].to(self.dtype)   # (1, T, E)
        out = AdaptorOutput(embed=x, padding_mask=padding_mask, pos_embed=pos_embed,
                            modal_id=slot.modality.value - 1)
        return self.finish(slot, out, generator)

    def forward_output(self, x: torch.Tensor, extra: Dict[str, Any], slot: SlotBatch):
        return self.out_proj_feat(x.float()), extra
