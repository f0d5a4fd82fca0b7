"""Decoder-side image-code adaptor (counterpart of
ofasys_tpu/adaptor/image_vqgan.py, ``image_vqgan``).

``<code>_i`` tokens embed through the shared token embedding. Positions
come from the code raster: cell (r, c) of the grid (``code_image_size //
code_downsample`` a side) takes slot ``r * image_bucket_size + c + 1`` of
``embed_image_positions``, and the leading bos step takes slot 0; a buffer
longer than the raster pads with slot 0. The self-attention bias is the
image-bucket relative bias (``image_rel_pos_table``). The output is the
tied projection of the shared embedding, in the compute dtype as
ofasys_tpu's ``attend`` computes it. Built on the decoder side only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.model.positional import image_bucket_count, make_image_bucket_position
from ofasys_torch.utils.pytree import SlotBatch


@dataclass
class ImageVqganAdaptorConfig:
    code_image_size: int = 256
    code_downsample: int = 8
    image_bucket_size: int = 42


@functools.lru_cache(maxsize=8)
def code_position_ids(grid: int, bucket_size: int, length: int) -> np.ndarray:
    """(max(grid * grid + 1, length),) int32 position slots of a code
    buffer of ``length`` steps: 0 for the bos step, the raster's grid
    slots, then 0 for steps past the raster."""
    pos_grid = (np.arange(grid)[None, :] + np.arange(grid)[:, None] * bucket_size + 1).reshape(-1)
    ids = np.concatenate([[0], pos_grid]).astype(np.int32)
    if len(ids) < length:
        ids = np.concatenate([ids, np.zeros(length - len(ids), np.int32)])
    return ids


def code_bucket(grid: int, bucket_size: int, length: int) -> np.ndarray:
    """(length, length) int32: the image bucket of a code buffer's first
    ``length`` steps."""
    ids = code_position_ids(grid, bucket_size, length + 1)[:length]
    full = make_image_bucket_position(bucket_size, image_bucket_count(bucket_size))
    return full[np.ix_(ids, ids)]


class ImageVqganAdaptor(BaseAdaptor):
    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype,
                 acfg: Optional[ImageVqganAdaptorConfig] = None):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.acfg = acfg = acfg or ImageVqganAdaptorConfig()
        bucket = acfg.image_bucket_size
        self.embed_image_positions = nn.Embedding(bucket * bucket + 1, self.embed_dim)
        if cfg.use_self_attn_bias:
            self.image_rel_pos_table = nn.Parameter(torch.zeros(
                self.num_bias_tables, image_bucket_count(bucket), self.num_heads))

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        acfg = self.acfg
        tokens = slot.value["inputs"]
        pos_offset = slot.value.get("pos_offset", 0)
        B, T = tokens.shape
        padding_mask = tokens == self.pad_id
        embed = self.embed_tokens.lookup(tokens).to(self.dtype)

        bucket = acfg.image_bucket_size
        ids = code_position_ids(acfg.code_image_size // acfg.code_downsample, bucket, T + 1)
        # a decode step past the buffer reads its last slot, as a dynamic slice clamps
        start = max(0, min(int(pos_offset), len(ids) - T))
        pos = torch.as_tensor(ids[start:start + T], dtype=torch.long, device=tokens.device)
        pos_embed = self.embed_image_positions.weight[pos][None].to(self.dtype)     # (1, T, E)

        rel_tables = getattr(self, "image_rel_pos_table", None)
        bucket_of = None
        if rel_tables is not None:
            bucket_of = functools.partial(code_bucket, acfg.code_image_size // acfg.code_downsample,
                                          bucket, T)
        out = AdaptorOutput(
            embed=embed, padding_mask=padding_mask, pos_embed=pos_embed,
            rel_tables=rel_tables, modal_id=slot.modality.value - 1, bucket_of=bucket_of,
        )
        return self.finish(slot, out, generator)

    def forward_output(self, x: torch.Tensor, extra: Dict[str, Any], slot: SlotBatch):
        B, T, E = x.shape
        logits = self.embed_tokens.attend(x.float().reshape(B * T, E), self.dtype)
        return logits.reshape(B, T, -1), extra
