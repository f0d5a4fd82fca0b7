"""Text adaptor: token ids -> embeddings; hidden states -> vocab logits
(counterpart of ofasys_tpu/adaptor/text.py): shared token embedding,
learned absolute positions, bucketed relative-position bias tables (one
per layer), tied output projection. ofasys_tpu's text adaptor config keeps
its defaults here: bucket size 256, tied projection, no output bias.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.model.positional import token_bucket, token_bucket_count
from ofasys_torch.utils.pytree import SlotBatch


TOKEN_BUCKET_SIZE = 256


class TextAdaptor(BaseAdaptor):
    """Token embeddings + positions + per-layer rel-pos bias tables."""

    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.max_pos = cfg.max_source_positions if is_src else cfg.max_target_positions
        self.embed_positions = nn.Embedding(self.max_pos + 2, self.embed_dim)
        if cfg.use_self_attn_bias:
            self.rel_pos_table = nn.Parameter(torch.zeros(
                self.num_bias_tables, token_bucket_count(TOKEN_BUCKET_SIZE), self.num_heads))

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        tokens = slot.value["inputs"]
        B, T = tokens.shape
        padding_mask = tokens == self.pad_id
        # pos_offset: absolute position of tokens[:, 0] (incremental decode
        # feeds one step at a time via GeneralistNet.decode_step)
        pos_offset = slot.value.get("pos_offset", 0)
        positions = pos_offset + torch.arange(T, device=tokens.device)
        pos_embed = self.embed_positions.weight[positions][None].to(self.dtype)   # (1, T, E)
        embed = self.embed_tokens.lookup(tokens).to(self.dtype)

        out = AdaptorOutput(
            embed=embed,
            padding_mask=padding_mask,
            pos_embed=pos_embed,
            rel_tables=getattr(self, "rel_pos_table", None),
            modal_id=slot.modality.value - 1,
            bucket_of=functools.partial(token_bucket, TOKEN_BUCKET_SIZE, self.max_pos, T),
        )
        return self.finish(slot, out, generator)

    def forward_output(self, x: torch.Tensor, extra: Dict[str, Any], slot: SlotBatch):
        """hidden -> vocab logits through the tied embedding, computed in the
        compute dtype."""
        B, T, E = x.shape
        logits = self.embed_tokens.attend(x.reshape(B * T, E), self.dtype)
        return logits.reshape(B, T, -1), extra
