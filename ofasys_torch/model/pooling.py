"""Pooling extra decoder (counterpart of ofasys_tpu/model/pooling.py;
reference ofasys/model/decoders/pooling.py:43, registered as
``ofasys.model.extra_decoders`` / ``pooling``): a classification head over
the pooled encoder output, for retrieval- and ITM-style heads beside the
generative decoder.

Parameters under ofasys_tpu's names (``dense``, ``out_proj``: fp32);
``dense`` computes in the head's dtype, ``out_proj`` in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.configure.config_store import register_config
from ofasys_torch.configure.configs import BaseDataclass
from ofasys_torch.ops import attention


@dataclass
class PoolingDecoderConfig(BaseDataclass):
    is_active: bool = False
    num_classes: int = 2
    pooling: str = "mean"        # 'mean' | 'max' | 'first'
    dropout: float = 0.1


class PoolingHead(nn.Module):
    def __init__(self, cfg: PoolingDecoderConfig, embed_dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.dense = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, cfg.num_classes)

    def forward(self, encoder_out: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """encoder_out (B, T, E), padding_mask (B, T) True = pad -> (B, C)
        fp32 logits; ``generator`` turns on training mode (dropout)."""
        x = encoder_out
        if self.cfg.pooling == "first":
            pooled = x[:, 0]
        else:
            keep = None if padding_mask is None else ~padding_mask
            if self.cfg.pooling == "max":
                masked = x if keep is None else x.masked_fill(~keep[:, :, None], float("-inf"))
                pooled = masked.max(dim=1).values
            elif keep is None:
                pooled = x.mean(dim=1)
            else:
                w = keep.to(x.dtype)[:, :, None]
                pooled = (x * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        h = F.linear(pooled.to(self.dtype), self.dense.weight.to(self.dtype),
                     self.dense.bias.to(self.dtype))
        h = attention.dropout(torch.tanh(h), self.cfg.dropout, generator)
        return F.linear(h.float(), self.out_proj.weight, self.out_proj.bias)


@register_config("ofasys.model.extra_decoders", "pooling", PoolingDecoderConfig)
class OFAPoolingModel(nn.Module):
    """The registry entry: a :class:`PoolingHead` over ``embed_dim``."""

    def __init__(self, cfg: PoolingDecoderConfig, embed_dim: int = 768,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.head = PoolingHead(cfg, embed_dim, dtype)

    def forward(self, encoder_out: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(encoder_out, padding_mask, generator)
