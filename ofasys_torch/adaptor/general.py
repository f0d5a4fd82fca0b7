"""GeneralAdaptor: dispatches slots to modality adaptors and concatenates
their outputs into one sequence (counterpart of ofasys_tpu/adaptor/general.py).

The concat layout is fixed per task template, so the combined relative-bias
bucket matrix (block-diagonal across slots) is built host-side once per
layout and kept on the device, and each layer's bias is one gather from a
combined table. The absolute-position q/k
bias is computed once per forward and shared by all layers, with batch dim 1
when positions are sample-independent.

flax creates an adaptor's parameters only on the side where a slot calls it,
so a param tree of ofasys_tpu holds ``image_vit`` and ``audio_fbank`` under
``encoder_adaptor`` alone and ``motion_6d``, ``audio_tgt_fbank`` and
``image_vqgan`` under ``decoder_adaptor`` alone. Modules here are built
eagerly: the source-only adaptors
(``SOURCE_ONLY``) are built on the encoder side only and the target-only
ones (``TARGET_ONLY``) on the decoder side only, so that
utils/jax_params.load_jax_params finds every parameter in the tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ofasys_torch import ModalityType
from ofasys_torch.adaptor.audio import (AudioFbankAdaptor, AudioFbankAdaptorConfig,
                                        AudioTgtFbankAdaptor, AudioTgtFbankAdaptorConfig)
from ofasys_torch.adaptor.base import AdaptorOutput, BaseAdaptor, BaseAdaptorConfig
from ofasys_torch.adaptor.image import (ImagePatchEmbedAdaptor, ImageResnetAdaptor,
                                        ImageResnetAdaptorConfig, ImageVitAdaptor)
from ofasys_torch.adaptor.image_vqgan import ImageVqganAdaptor, ImageVqganAdaptorConfig
from ofasys_torch.adaptor.motion import Motion6dAdaptor, Motion6dAdaptorConfig
from ofasys_torch.adaptor.text import TextAdaptor
from ofasys_torch.adaptor.video import VideoAdaptorConfig, VideoImageSequenceAdaptor
from ofasys_torch.configure.config_store import ConfigStore
from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.model.positional import block_diag_buckets
from ofasys_torch.model.transformer import BiasSpec, Dense, RelBucket
from ofasys_torch.utils.pytree import SlotBatch

# Default adaptor per modality.
DEFAULT_ADAPTOR_BY_MODALITY = {
    ModalityType.TEXT: "text",
    ModalityType.IMAGE: "image_vit",
    ModalityType.BOX: "text",
    ModalityType.AUDIO: "audio_fbank",
    ModalityType.MOTION: "motion_6d",
    ModalityType.PHONE: "text",
    ModalityType.VIDEO: "video_image_sequence",
    ModalityType.STRUCT: "text",
    ModalityType.CATEGORY: "text",
}


def resolve_adaptor_name(slot: SlotBatch, is_src: bool) -> str:
    name = slot.adaptor_name or (slot.get_attr("adaptor") if slot.attributes else None)
    if name:
        return name
    if slot.modality == ModalityType.IMAGE and not is_src:
        return "image_vqgan"
    if slot.modality == ModalityType.AUDIO and not is_src:
        return "audio_tgt_fbank"
    return DEFAULT_ADAPTOR_BY_MODALITY[slot.modality]


ADAPTORS = {"text": TextAdaptor, "image_resnet": ImageResnetAdaptor, "image_vit": ImageVitAdaptor,
            "image_patch_embed": ImagePatchEmbedAdaptor, "audio_fbank": AudioFbankAdaptor,
            "motion_6d": Motion6dAdaptor, "audio_tgt_fbank": AudioTgtFbankAdaptor,
            "image_vqgan": ImageVqganAdaptor, "video_image_sequence": VideoImageSequenceAdaptor}
# input adaptors no target slot resolves to: built on the encoder side only
SOURCE_ONLY = ("image_resnet", "image_vit", "image_patch_embed", "audio_fbank",
               "video_image_sequence")
# output adaptors of the diffusion, TTS and image-code targets, which no
# source slot of the ported tasks resolves to: built on the decoder side only
TARGET_ONLY = ("motion_6d", "audio_tgt_fbank", "image_vqgan")


# adaptors that take a config of their own; the store holds it under
# ofasys.adaptor/<name> (the others register the empty BaseAdaptorConfig)
CONFIGURED = {"image_resnet": ImageResnetAdaptorConfig, "audio_fbank": AudioFbankAdaptorConfig,
              "motion_6d": Motion6dAdaptorConfig, "audio_tgt_fbank": AudioTgtFbankAdaptorConfig,
              "image_vqgan": ImageVqganAdaptorConfig, "video_image_sequence": VideoAdaptorConfig}
for _name, _cls in ADAPTORS.items():
    ConfigStore().store("ofasys.adaptor", _name, CONFIGURED.get(_name, BaseAdaptorConfig), _cls)


def build_adaptor(name: str, cfg, is_src, embed_tokens, pad_id, dtype, acfg=None) -> BaseAdaptor:
    """``acfg``: the adaptor's own config (``CONFIGURED``), else the one the
    ConfigStore holds for it."""
    if name not in ADAPTORS:
        raise KeyError(f"unknown adaptor {name!r}; registered: {sorted(ADAPTORS)}")
    if acfg is None and name in CONFIGURED:
        acfg = ConfigStore().get("ofasys.adaptor", name).config
    own = () if acfg is None else (acfg,)
    return ADAPTORS[name](cfg, is_src, embed_tokens, pad_id, dtype, *own)


# combined relative-position buckets kept on the device per general adaptor
BUCKET_CACHE = 8


@dataclasses.dataclass
class GeneralAdaptorOutput:
    embed: torch.Tensor              # (B, T, E)
    padding_mask: torch.Tensor       # (B, T) True = pad
    pos_embed: torch.Tensor          # (B|1, T, E)
    bias_spec: Optional[BiasSpec]
    # (start, end, modal_id) of each run of same-modality slots, for modal_ffn
    modal_spans: Tuple[Tuple[int, int, int], ...] = ()


class GeneralAdaptor(nn.Module):
    """One per side (encoder / decoder)."""

    def __init__(self, cfg: GeneralistModelConfig, is_src: bool, embed_tokens: nn.Embedding,
                 active_adaptors: Tuple[str, ...], pad_id: int, dtype: torch.dtype,
                 adaptor_cfgs: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        self.is_src = is_src
        self.active_adaptors = tuple(n for n in active_adaptors
                                     if n not in (TARGET_ONLY if is_src else SOURCE_ONLY))
        adaptor_cfgs = adaptor_cfgs or {}
        for name in self.active_adaptors:
            self.add_module(name, build_adaptor(name, cfg, is_src, embed_tokens, pad_id, dtype,
                                                adaptor_cfgs.get(name)))
        self._bucket_cache: Dict[Any, RelBucket] = {}
        heads = cfg.encoder.attention_heads if is_src else cfg.decoder.attention_heads
        embed_dim = cfg.encoder.embed_dim
        self.num_attention_heads = heads
        self.pos_scaling = float(embed_dim / heads * cfg.attn_scale_factor) ** -0.5
        if cfg.use_self_attn_bias and not cfg.entangle_position_embedding:
            self.pos_q_linear = Dense(embed_dim, embed_dim, dtype, cfg)
            self.pos_k_linear = Dense(embed_dim, embed_dim, dtype, cfg)

    def get_adaptor(self, slot: SlotBatch) -> BaseAdaptor:
        name = resolve_adaptor_name(slot, self.is_src)
        if name not in self.active_adaptors:
            raise KeyError(
                f"adaptor {name!r} needed by slot {slot.column_name!r} is not active; "
                f"active: {sorted(self.active_adaptors)}"
            )
        return getattr(self, name)

    def build_abs_pos_bias(self, pos_embed: torch.Tensor) -> torch.Tensor:
        """(B|1, H, T, T) fp32 absolute-position attention bias."""
        B, T, E = pos_embed.shape
        H = self.num_attention_heads
        pos_q = self.pos_q_linear(pos_embed).reshape(B, T, H, -1) * self.pos_scaling
        pos_k = self.pos_k_linear(pos_embed).reshape(B, T, H, -1)
        return torch.matmul(pos_q.permute(0, 2, 1, 3).float(), pos_k.permute(0, 2, 3, 1).float())

    def forward(self, slots: List[SlotBatch], generator: Optional[torch.Generator] = None,
                noise_generator: Optional[torch.Generator] = None) -> GeneralAdaptorOutput:
        """``generator`` turns on training mode (embedding dropout);
        ``noise_generator`` goes to the adaptors that draw inference-time
        noise (the TTS prenet's dropout)."""
        outputs: List[AdaptorOutput] = [
            self.get_adaptor(slot)(slot, generator) if noise_generator is None
            else self.get_adaptor(slot)(slot, generator, noise_generator=noise_generator)
            for slot in slots]

        embed = torch.cat([o.embed for o in outputs], dim=1)
        padding_mask = torch.cat([o.padding_mask for o in outputs], dim=1)
        # pos_embed batch dims may be mixed (1 vs B) — broadcast to a common dim
        pb = max(o.pos_embed.shape[0] for o in outputs)
        pos_embed = torch.cat(
            [o.pos_embed.expand((pb,) + tuple(o.pos_embed.shape[1:])) for o in outputs], dim=1
        )

        # modality spans (adjacent same-modality slots merged)
        spans: List[Tuple[int, int, int]] = []
        start = 0
        for o in outputs:
            end = start + o.seq_length
            if spans and spans[-1][2] == o.modal_id:
                spans[-1] = (spans[-1][0], end, o.modal_id)
            else:
                spans.append((start, end, o.modal_id))
            start = end

        bias_spec = None
        if self.cfg.use_self_attn_bias:
            abs_bias = None
            if not self.cfg.entangle_position_embedding:
                abs_bias = self.build_abs_pos_bias(pos_embed)
            # combined rel-bias: one bucket matrix + one concatenated table
            have_rel = [o for o in outputs if o.rel_tables is not None]
            bucket = tables = None
            if have_rel:
                n_tables = have_rel[0].rel_tables.shape[0]
                heads = have_rel[0].rel_tables.shape[-1]
                table_list = [o.rel_tables for o in have_rel]
                ref = have_rel[0].rel_tables
                zero_row = torch.zeros((n_tables, 1, heads), dtype=ref.dtype, device=ref.device)
                tables = torch.cat([zero_row] + table_list, dim=1)
                bucket = self._combined_bucket(outputs, ref.device)
            bias_spec = BiasSpec(rel_bucket=bucket, tables=tables, abs_bias=abs_bias)

        return GeneralAdaptorOutput(
            embed=embed,
            padding_mask=padding_mask,
            pos_embed=pos_embed,
            bias_spec=bias_spec,
            modal_spans=tuple(spans),
        )

    def _combined_bucket(self, outputs: List[AdaptorOutput], device) -> RelBucket:
        """The block-diagonal bucket of the slots' outputs on ``device``,
        built where the layout (each slot's ``bucket_key``, length and table
        size) is not among the last ``BUCKET_CACHE`` kept: a video clip's
        bucket is built and copied to the card once."""
        key = tuple((None, o.seq_length, 0) if o.rel_tables is None
                    else (o.bucket_key, o.seq_length, o.rel_tables.shape[1]) for o in outputs)
        entry = self._bucket_cache.get((key, device))
        if entry is None:
            buckets = [o.rel_bucket if o.rel_tables is not None
                       else np.full((o.seq_length, o.seq_length), -1, np.int32) for o in outputs]
            if len(self._bucket_cache) >= BUCKET_CACHE:
                self._bucket_cache.pop(next(iter(self._bucket_cache)))
            entry = RelBucket(block_diag_buckets(buckets, [k[2] for k in key]), device)
            self._bucket_cache[(key, device)] = entry
        return entry

    def forward_output(self, x: torch.Tensor, extra: Dict[str, Any], slots: List[SlotBatch]):
        """Dispatch hidden states to the (single) target slot's output adaptor."""
        target = SlotBatch.target_slot(slots)
        return self.get_adaptor(target).forward_output(x, extra, target)
