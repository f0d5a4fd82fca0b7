"""Audio input adaptor (counterpart of ofasys_tpu/adaptor/audio.py,
``audio_fbank``).

``audio_fbank`` (encoder side): two stride-2 convolutions with exact GELU
subsample the fbank frames 4x, a projection to the model width, learned
positions and a token-bucket relative bias. For wav2vec-style pretraining,
``mask_channel_indices`` (B, n_mels) zero whole fbank channels and
``mask_indices`` (B, Ts) put the learned ``mask_emb`` at the subsampled
frames. ``extra_encoder_layers`` runs that many encoder layers over the
subsampled frames inside the adaptor.

The convolutions keep flax's ``nn.Conv`` parameter names and layout
(``subsample_{i}.kernel`` (5, in, out), ``subsample_{i}.bias``) and run
through ``F.conv1d``, as ofasys_tpu runs them through XLA's convolution.
Frames past a request's length are not masked between the convolutions:
``collate`` pads with 0.0, and the second convolution sees ``gelu(bias)``
there, as in ofasys_tpu, so a request's encoder states depend on the
longest request of its batch.

The TTS adaptor ``audio_tgt_fbank`` is not ported (ROADMAP Queue A item 10,
with ``tacotron2_loss`` and ``speech_generator``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor
from ofasys_torch.model.positional import make_token_bucket_position, token_bucket_count
from ofasys_torch.model.transformer import Dense, TransformerEncoderLayer
from ofasys_torch.utils.pytree import SlotBatch

CONV_KERNEL, CONV_STRIDE, CONV_PAD = 5, 2, 2


@dataclass
class AudioFbankAdaptorConfig:
    num_mels: int = 80
    subsample_stride: int = 4       # total conv subsampling factor (2x2)
    conv_channels: int = 256
    token_bucket_size: int = 256
    mask_length: int = 10
    mask_channel_length: int = 10
    extra_encoder_layers: int = 0


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over (B, T, C) with kernel (k, in, out), stride 2
    and padding (2, 2): fp32 parameters, compute in ``dtype``. Output
    length ceil(T / 2)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(CONV_KERNEL, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # (B, T, in)
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), self.kernel.permute(2, 1, 0).to(self.dtype),
                     self.bias.to(self.dtype), stride=CONV_STRIDE, padding=CONV_PAD)
        return y.transpose(1, 2)


class AudioFbankAdaptor(BaseAdaptor):
    def __init__(self, cfg, is_src, embed_tokens, pad_id, dtype,
                 acfg: Optional[AudioFbankAdaptorConfig] = None):
        super().__init__(cfg, is_src, embed_tokens, pad_id, dtype)
        self.acfg = acfg = acfg or AudioFbankAdaptorConfig()
        E = self.embed_dim
        self.n_convs = max(1, int(math.log2(acfg.subsample_stride)))
        width = acfg.num_mels
        for i in range(self.n_convs):
            self.add_module(f"subsample_{i}", Conv1d(width, acfg.conv_channels, dtype))
            width = acfg.conv_channels
        self.proj = Dense(width, E, dtype, cfg)
        self.mask_emb = nn.Parameter(torch.zeros(E))
        for i in range(acfg.extra_encoder_layers):
            self.add_module(f"extra_layers_{i}", TransformerEncoderLayer(cfg, dtype))
        self.max_pos = cfg.max_source_positions
        self.embed_positions = nn.Embedding(self.max_pos + 2, E)
        if cfg.use_self_attn_bias:
            self.rel_pos_table = nn.Parameter(torch.zeros(
                self.num_bias_tables, token_bucket_count(acfg.token_bucket_size), self.num_heads))

    def forward(self, slot: SlotBatch, generator: Optional[torch.Generator] = None) -> AdaptorOutput:
        acfg = self.acfg
        feats = slot.value["inputs"].to(self.dtype)            # (B, T, M)
        lengths = slot.value.get("lengths")
        B, T, _ = feats.shape

        chan_mask = slot.value.get("mask_channel_indices")
        if chan_mask is not None:
            feats = torch.where(chan_mask[:, None, :].bool(), torch.zeros((), dtype=feats.dtype,
                                                                           device=feats.device), feats)
        x = feats
        for i in range(self.n_convs):
            x = F.gelu(getattr(self, f"subsample_{i}")(x))
        x = self.proj(x)
        Ts = x.shape[1]
        # ceil(T / 2) per stage is ceil(T / stride) overall, the length rule below
        assert Ts == -(-T // 2 ** self.n_convs)

        frame_mask = slot.value.get("mask_indices")
        if frame_mask is not None:
            x = torch.where(frame_mask[:, :, None].bool(), self.mask_emb.to(x.dtype), x)

        if lengths is not None:
            sub_lengths = torch.ceil(lengths.float() / acfg.subsample_stride).int()
            padding_mask = torch.arange(Ts, device=x.device)[None, :] >= sub_lengths[:, None]
        else:
            padding_mask = torch.zeros((B, Ts), dtype=torch.bool, device=x.device)

        if acfg.extra_encoder_layers > 0:
            keep = torch.logical_not(padding_mask)[:, None, None, :]
            for i in range(acfg.extra_encoder_layers):
                x = getattr(self, f"extra_layers_{i}")(x, keep, None, generator)

        positions = torch.arange(Ts, device=x.device)
        pos_embed = self.embed_positions.weight[positions][None].to(self.dtype)   # (1, Ts, E)
        rel_tables = getattr(self, "rel_pos_table", None)
        rel_bucket = None
        if rel_tables is not None:
            rel_bucket = make_token_bucket_position(acfg.token_bucket_size, self.max_pos)[:Ts, :Ts]
        out = AdaptorOutput(
            embed=x, padding_mask=padding_mask, pos_embed=pos_embed,
            rel_bucket=rel_bucket, rel_tables=rel_tables, modal_id=slot.modality.value - 1,
        )
        return self.finish(slot, out, generator)
