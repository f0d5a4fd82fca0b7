"""Adaptor layer: modality tensors <-> unified embedding sequences
(counterpart of ofasys_tpu/adaptor/base.py).

An adaptor has two roles: ``forward`` (input adaptor: slot batch ->
AdaptorOutput) and ``forward_output`` (output adaptor: hidden states ->
modality logits). It returns a builder of its host-side bucket matrix and
stacked per-layer bias tables; layers gather the bias lazily
(model/transformer.py BiasSpec).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Hashable, Optional

import numpy as np
import torch
from torch import nn

from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.model.transformer import LayerNorm
from ofasys_torch.ops import attention
from ofasys_torch.utils.pytree import SlotBatch


@dataclasses.dataclass
class BaseAdaptorConfig:
    """The config of an adaptor that takes none of its own."""


@dataclasses.dataclass
class AdaptorOutput:
    """One slot's adapted sequence.

    embed:        (B, T, E)
    padding_mask: (B, T) bool, True = PAD
    pos_embed:    (1 or B, T, E) absolute position embeddings
    rel_tables:   (n_tables, n_buckets, H) or None — per-layer bias tables
    modal_id:     int (ModalityType.value - 1), for modal_ffn expert spans
    bucket_of:    builder of the (T, T) int32 bucket, set with ``rel_tables``:
                  a ``functools.partial`` of a pure function of shapes, so its
                  function and arguments (``bucket_key``) name the bucket and
                  the general adaptor builds it only where it keeps no copy
    """

    embed: torch.Tensor
    padding_mask: torch.Tensor
    pos_embed: torch.Tensor
    rel_tables: Optional[torch.Tensor] = None
    modal_id: int = 0
    bucket_of: Optional[functools.partial] = None

    @property
    def seq_length(self) -> int:
        return self.embed.shape[1]

    @property
    def bucket_key(self) -> Optional[Hashable]:
        f = self.bucket_of
        return None if f is None else (f.func, f.args)

    @property
    def rel_bucket(self) -> Optional[np.ndarray]:
        """(T, T) int32, built anew."""
        return None if self.bucket_of is None else self.bucket_of()


class BaseAdaptor(nn.Module):
    """Shared embed post-processing: type embedding (source side),
    embedding and position layernorms, embedding dropout. ofasys_tpu's
    per-adaptor config keeps its defaults here (no embed scaling, both
    layernorms, type embedding where the model config asks for them);
    ``dropout``, the adaptor's own rate, overrides ``cfg.dropout`` when set."""

    dropout: Optional[float] = None

    def __init__(self, cfg: GeneralistModelConfig, is_src: bool,
                 embed_tokens: nn.Embedding, pad_id: int, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.is_src = is_src
        # the net owns the shared token embedding; keep a reference without
        # registering it here, so its parameter has one name
        self.__dict__["embed_tokens"] = embed_tokens
        self.pad_id = pad_id
        self.dtype = dtype
        E = self.embed_dim
        if is_src and cfg.add_type_embedding:
            self.type_embedding = nn.Parameter(torch.zeros(E))
        if cfg.layernorm_embedding:
            self.layernorm_embedding = LayerNorm(E, dtype)
        self.layernorm_position = LayerNorm(E, dtype)

    @property
    def num_layers(self) -> int:
        return self.cfg.encoder.layers if self.is_src else self.cfg.decoder.layers

    @property
    def num_bias_tables(self) -> int:
        return 1 if self.cfg.share_attn_bias else self.num_layers

    @property
    def num_heads(self) -> int:
        return self.cfg.encoder.attention_heads if self.is_src else self.cfg.decoder.attention_heads

    @property
    def embed_dim(self) -> int:
        return self.cfg.encoder.embed_dim

    def finish(self, slot: SlotBatch, out: AdaptorOutput,
               generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        """``generator`` turns on training mode (embedding dropout)."""
        embed = out.embed
        if self.cfg.entangle_position_embedding and out.pos_embed is not None:
            embed = embed + out.pos_embed.to(embed.dtype)
        if slot.is_src and hasattr(self, "type_embedding"):
            embed = embed + self.type_embedding.to(embed.dtype)
        if hasattr(self, "layernorm_embedding"):
            embed = self.layernorm_embedding(embed)
        pos_embed = out.pos_embed
        if pos_embed is not None:
            pos_embed = self.layernorm_position(pos_embed)
        rate = self.dropout if self.dropout is not None else self.cfg.dropout
        embed = attention.dropout(embed, rate, generator)
        return dataclasses.replace(out, embed=embed, pos_embed=pos_embed)

    # ---- output adaptor ----
    def forward_output(self, x: torch.Tensor, extra: Dict[str, Any], slot: SlotBatch):
        return x, extra
