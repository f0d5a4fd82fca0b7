"""Video adaptor (counterpart of ofasys_tpu/adaptor/video.py): per-frame
patch embedding plus learned spatial and temporal position embeddings;
the frames flatten into one sequence of N * h * w patches.

The relative-position bucket is block-diagonal over frames: the image
bucket of the spatial positions within a frame, the -1 sentinel (the
combined table's zero row) across frames. At the default clip (8 frames of
224 px, 1,568 patches) it is a 9.8 MB int32 matrix: the general adaptor
builds it once per layout and keeps the combined bucket on the device
(``AdaptorOutput.bucket_of``).

Layout: (B, N, H, W, 3) in; (B, N*h*w, E) out.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.adaptor.image import (IMAGE_BUCKET_SIZE, PATCH_SIZE, PatchEmbed, _grid_positions,
                                        image_bucket)
from ofasys_torch.model.positional import image_bucket_count
from ofasys_torch.utils.pytree import SlotBatch


@dataclass
class VideoAdaptorConfig:
    patch_size: int = PATCH_SIZE
    max_frames: int = 32
    image_bucket_size: int = IMAGE_BUCKET_SIZE


def video_bucket(num_frames: int, h: int, w: int, bucket_size: int) -> np.ndarray:
    """(N*h*w, N*h*w) int32: each frame's spatial image bucket on the
    diagonal blocks, -1 across frames."""
    per_frame = image_bucket(h, w, bucket_size)
    n = h * w
    out = -np.ones((num_frames * n, num_frames * n), np.int32)
    for f in range(num_frames):
        out[f * n:(f + 1) * n, f * n:(f + 1) * n] = per_frame
    return out


class VideoImageSequenceAdaptor(BaseAdaptor):
    """Registered as ``video_image_sequence``; parameters under
    ofasys_tpu's names (``patch_embed``, ``embed_image_positions``,
    ``embed_frame_positions``, ``image_rel_pos_table``)."""

    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype,
                 acfg: Optional[VideoAdaptorConfig] = None):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.acfg = acfg = acfg or VideoAdaptorConfig()
        bs = acfg.image_bucket_size
        self.patch_embed = PatchEmbed(self.embed_dim, acfg.patch_size, dtype)
        self.embed_image_positions = nn.Embedding(bs * bs + 1, self.embed_dim)
        self.embed_frame_positions = nn.Embedding(acfg.max_frames, self.embed_dim)
        if cfg.use_self_attn_bias:
            self.image_rel_pos_table = nn.Parameter(torch.zeros(
                self.num_bias_tables, image_bucket_count(bs), self.num_heads))

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        videos = (slot.value["inputs"] if isinstance(slot.value, dict) else slot.value).to(self.dtype)
        B, N, H, W, C = videos.shape
        x = self.patch_embed(videos.reshape(B * N, H, W, C))
        h, w = x.shape[1], x.shape[2]
        E = self.embed_dim
        x = x.reshape(B, N, h * w, E)

        bs = self.acfg.image_bucket_size
        pos_ids = torch.as_tensor(_grid_positions(h, w, bs), dtype=torch.long, device=x.device)
        spatial = self.embed_image_positions.weight[pos_ids][None].to(self.dtype)          # (1, hw, E)
        temporal = self.embed_frame_positions.weight[:N][None].to(self.dtype)               # (1, N, E)
        pos = spatial[:, None, :, :] + temporal[:, :, None, :]                              # (1, N, hw, E)
        embed = (x + temporal[:, :, None, :].to(x.dtype)).reshape(B, N * h * w, E)

        rel_tables = bucket_of = None
        if self.cfg.use_self_attn_bias:
            bucket_of = functools.partial(video_bucket, N, h, w, bs)
            rel_tables = self.image_rel_pos_table
        out = AdaptorOutput(
            embed=embed,
            padding_mask=torch.zeros((B, N * h * w), dtype=torch.bool, device=x.device),
            pos_embed=pos.reshape(1, N * h * w, E),
            rel_tables=rel_tables,
            modal_id=slot.modality.value - 1,
            bucket_of=bucket_of,
        )
        return self.finish(slot, out, generator)
