"""Image input adaptors (counterpart of ofasys_tpu/adaptor/image.py).

``image_vit`` and ``image_patch_embed`` produce the same AdaptorOutput:
patch-grid embeddings with a 2-D bucketed relative-position bias and
learned absolute grid positions. The grid (h, w) follows from the image
size the preprocessor fixes, so the bucket sub-matrix is computed
host-side. ofasys_tpu's image adaptor configs keep their defaults here
(bucket size 42, patch 16, no extra trunk layers). ``image_resnet`` waits
for ``model/resnet.py`` (ROADMAP Queue A item 7).

Layout: NHWC (B, H, W, 3) in; flattened (B, h*w, E) out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.model.positional import image_bucket_count, make_image_bucket_position
from ofasys_torch.model.transformer import TransformerEncoderLayer
from ofasys_torch.utils.pytree import SlotBatch

IMAGE_BUCKET_SIZE = 42         # max grid side for rel-pos buckets
PATCH_SIZE = 16
IMAGE_CHANNELS = 3
VIT_LAYERS = 0                 # extra transformer layers in the trunk


class PatchEmbed(nn.Module):
    """Non-overlapping patch projection as space-to-depth + one matmul:
    identical to a (p, p) convolution with stride p, and it keeps that
    module's parameter layout (``kernel`` (p, p, C, E) + ``bias``), fp32
    parameters, compute in ``dtype``."""

    def __init__(self, features: int, patch: int, dtype: torch.dtype):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(patch, patch, IMAGE_CHANNELS, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, images: torch.Tensor) -> torch.Tensor:   # (B, H, W, C)
        p = self.patch
        B, H, W, C = images.shape
        h, w = H // p, W // p
        x = images[:, : h * p, : w * p].reshape(B, h, p, w, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, h * w, p * p * C)
        y = torch.matmul(x.to(self.dtype), self.kernel.reshape(p * p * C, -1).to(self.dtype))
        return (y + self.bias.to(self.dtype)).reshape(B, h, w, -1)


def _grid_positions(h: int, w: int, bucket_size: int) -> np.ndarray:
    """Flattened grid positions into the bucket_size x bucket_size table,
    offset by 1 for the CLS row."""
    idx = np.arange(w)[None, :] + np.arange(h)[:, None] * bucket_size + 1
    return idx.reshape(-1).astype(np.int32)


class _ImageAdaptorMixin(BaseAdaptor):
    """Shared grid-position / rel-bias logic for image trunks."""

    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.embed_image_positions = nn.Embedding(IMAGE_BUCKET_SIZE * IMAGE_BUCKET_SIZE + 1,
                                                  self.embed_dim)
        if cfg.use_self_attn_bias:
            self.image_rel_pos_table = nn.Parameter(torch.zeros(
                self.num_bias_tables, image_bucket_count(IMAGE_BUCKET_SIZE), self.num_heads))

    def finish_image(self, slot: SlotBatch, feat: torch.Tensor,
                     generator: Optional[torch.Generator]) -> AdaptorOutput:
        """feat: (B, h, w, E) trunk output."""
        B, h, w, E = feat.shape
        embed = feat.reshape(B, h * w, E)

        pos_ids = _grid_positions(h, w, IMAGE_BUCKET_SIZE)
        positions = torch.as_tensor(pos_ids, dtype=torch.long, device=feat.device)
        pos_embed = self.embed_image_positions.weight[positions][None].to(self.dtype)  # (1, hw, E)

        rel_tables = rel_bucket = None
        if self.cfg.use_self_attn_bias:
            n_rel = image_bucket_count(IMAGE_BUCKET_SIZE)
            full_bucket = make_image_bucket_position(IMAGE_BUCKET_SIZE, n_rel)
            rel_bucket = full_bucket[np.ix_(pos_ids, pos_ids)]
            rel_tables = self.image_rel_pos_table

        out = AdaptorOutput(
            embed=embed,
            padding_mask=torch.zeros((B, h * w), dtype=torch.bool, device=feat.device),
            pos_embed=pos_embed,
            rel_bucket=rel_bucket,
            rel_tables=rel_tables,
            modal_id=slot.modality.value - 1,
        )
        return self.finish(slot, out, generator)

    @staticmethod
    def get_images(slot: SlotBatch) -> torch.Tensor:
        return slot.value["inputs"] if isinstance(slot.value, dict) else slot.value


class ImageVitAdaptor(_ImageAdaptorMixin):
    """Patch embedding + optional local transformer layers."""

    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype, vit_layers: int = VIT_LAYERS):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.patch_embed = PatchEmbed(self.embed_dim, PATCH_SIZE, dtype)
        self.vit_layers = vit_layers
        for i in range(vit_layers):
            self.add_module(f"vit_layers_{i}", TransformerEncoderLayer(cfg, dtype))

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        images = self.get_images(slot).to(self.dtype)           # (B, H, W, 3)
        feat = self.patch_embed(images)
        B, h, w, E = feat.shape
        if self.vit_layers > 0:
            x = feat.reshape(B, h * w, E)
            for i in range(self.vit_layers):
                x = getattr(self, f"vit_layers_{i}")(x, generator=generator)
            feat = x.reshape(B, h, w, E)
        return self.finish_image(slot, feat, generator)


class ImagePatchEmbedAdaptor(ImageVitAdaptor):
    """Raw patch embedding (registered as 'image_patch_embed')."""
