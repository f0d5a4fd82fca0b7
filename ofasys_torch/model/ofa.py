"""GeneralistModel: one shared encoder-decoder over all modalities/tasks
(counterpart of ofasys_tpu/model/ofa.py).

  * :class:`GeneralistNet` — the ``nn.Module``: encoder GeneralAdaptor ->
    TransformerEncoder -> decoder GeneralAdaptor -> TransformerDecoder ->
    output adaptor. ``forward`` / ``decode_full`` run whole sequences;
    ``encode`` / ``decode_prepare`` / ``decode_step`` serve the generator.
  * :class:`GeneralistModel` — the user-facing object with ofasys_tpu's
    lifecycle (``initialize(global_dict)`` after the vocab is final).

Parameters are fp32 and laid out like the flax tree (see
utils/jax_params.py); compute runs in the ``dtype`` given to ``initialize``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ofasys_torch.adaptor.audio import Conv1d
from ofasys_torch.adaptor.general import GeneralAdaptor
from ofasys_torch.adaptor.image import PatchEmbed
from ofasys_torch.configure.config_store import ConfigStore, register_config
from ofasys_torch.model.config import QUANT_TRAINING, GeneralistModelConfig, apply_arch, check_layout
from ofasys_torch.model.resnet import init_resnet_
from ofasys_torch.model.transformer import (
    BiasSpec,
    Dense,
    Embed,
    MoEFeedForward,
    MultiheadAttention,
    TransformerDecoder,
    TransformerEncoder,
)
from ofasys_torch.utils.device import resolve_device
from ofasys_torch.utils.pytree import SlotBatch


@dataclasses.dataclass
class EncoderOut:
    """Passed from encode to decode."""

    x: torch.Tensor                 # (B, Ts, E)
    padding_mask: torch.Tensor      # (B, Ts) True = pad
    pos_embed: torch.Tensor         # (B|1, Ts, E)


class GeneralistNet(nn.Module):
    """``adaptor_cfgs``: configs of the adaptors that take one, by name.
    ``modal_ids`` (under ``cfg.modal_ffn``): the FeedForward experts of the
    ``"encoder"`` and ``"decoder"`` stacks."""

    def __init__(self, cfg: GeneralistModelConfig, vocab_size: int, pad_id: int,
                 active_adaptors: Tuple[str, ...], dtype: torch.dtype = torch.bfloat16,
                 adaptor_cfgs: Optional[Dict[str, Any]] = None,
                 modal_ids: Optional[Dict[str, Tuple[int, ...]]] = None):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.dtype = dtype
        self.active_adaptors = tuple(active_adaptors)
        E = cfg.encoder.embed_dim
        self.embed_tokens = Embed(vocab_size, E)
        self.encoder_adaptor = GeneralAdaptor(cfg, True, self.embed_tokens, active_adaptors,
                                              pad_id, dtype, adaptor_cfgs)
        self.decoder_adaptor = GeneralAdaptor(cfg, False, self.embed_tokens, active_adaptors,
                                              pad_id, dtype, adaptor_cfgs)
        modal_ids = modal_ids or {}
        self.encoder = TransformerEncoder(cfg, dtype, modal_ids.get("encoder"))
        self.decoder = TransformerDecoder(cfg, dtype, modal_ids.get("decoder"))
        if cfg.use_self_attn_bias:
            # cross-attention absolute-position bias, shared across decoder layers
            self.cross_pos_q_linear = Dense(E, E, dtype, cfg)
            self.cross_pos_k_linear = Dense(E, E, dtype, cfg)
            self.cross_pos_scaling = float(E / cfg.decoder.attention_heads * cfg.attn_scale_factor) ** -0.5

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    # ------------------------------------------------------------- helpers
    def cross_bias(self, tgt_pos_embed: torch.Tensor, src_pos_embed: torch.Tensor) -> Optional[torch.Tensor]:
        """(B|1, H, Tq, Tk) fp32 cross-attention position bias."""
        if not self.cfg.use_self_attn_bias:
            return None
        H = self.cfg.decoder.attention_heads
        Bq, Tq = tgt_pos_embed.shape[:2]
        Bk, Tk = src_pos_embed.shape[:2]
        B = max(Bq, Bk)
        pos_q = self.cross_pos_q_linear(tgt_pos_embed).reshape(Bq, Tq, H, -1) * self.cross_pos_scaling
        pos_k = self.cross_pos_k_linear(src_pos_embed).reshape(Bk, Tk, H, -1)
        pos_q = pos_q.expand((B,) + tuple(pos_q.shape[1:]))
        pos_k = pos_k.expand((B,) + tuple(pos_k.shape[1:]))
        return torch.matmul(pos_q.permute(0, 2, 1, 3).float(), pos_k.permute(0, 2, 3, 1).float())

    # -------------------------------------------------------------- encode
    def encode(self, src_slots: List[SlotBatch],
               generator: Optional[torch.Generator] = None) -> EncoderOut:
        a = self.encoder_adaptor(src_slots, generator)
        x = self.encoder(a.embed, padding_mask=torch.logical_not(a.padding_mask),
                         bias_spec=a.bias_spec, generator=generator,
                         modal_spans=a.modal_spans if self.cfg.modal_ffn else None)
        return EncoderOut(x=x, padding_mask=a.padding_mask, pos_embed=a.pos_embed)

    # ------------------------------------------------------ whole sequences
    def forward(self, slots: List[SlotBatch], full_context: bool = False,
                generator: Optional[torch.Generator] = None, hidden_only: bool = False):
        """Full forward: returns (output, extra); for text targets the output
        is vocab logits (B, Tt, V) in the compute dtype. ``generator`` (on
        the net's device) turns on training mode, as ``deterministic=False``
        with a dropout rng does in flax; None is deterministic.
        ``hidden_only``: the output is None and only ``extra["decoder_hidden"]``
        is computed (the chunked-vocab criterion projects it itself)."""
        src_slots = SlotBatch.source_slots(slots)
        tgt_slots = [s for s in slots if not s.is_src]
        enc = self.encode(src_slots, generator) if src_slots else None
        out, extra = self.decode_full(tgt_slots, enc, full_context=full_context, all_slots=slots,
                                      generator=generator, hidden_only=hidden_only)
        if enc is not None:
            extra["encoder_out"] = enc
        return out, extra

    def decode_full(self, tgt_slots: List[SlotBatch], enc: Optional[EncoderOut],
                    full_context: bool = False, all_slots: Optional[List[SlotBatch]] = None,
                    generator: Optional[torch.Generator] = None, hidden_only: bool = False):
        """Decoder-side forward against a (possibly reused) encoder-out."""
        d = self.decoder_adaptor(tgt_slots, generator)
        cb = self.cross_bias(d.pos_embed, enc.pos_embed) if enc is not None else None
        x, _ = self.decoder(
            d.embed,
            enc.x if enc is not None else None,
            self_padding_mask=torch.logical_not(d.padding_mask),
            encoder_padding_mask=None if enc is None else torch.logical_not(enc.padding_mask),
            self_bias_spec=d.bias_spec,
            cross_bias=cb,
            full_context=full_context,
            generator=generator,
            modal_spans=d.modal_spans if self.cfg.modal_ffn else None,
        )
        extra: Dict[str, Any] = {"decoder_hidden": x}
        if hidden_only:
            return None, extra
        return self.decoder_adaptor.forward_output(x, extra, all_slots or tgt_slots)

    # ------------------------------------------------- incremental decoding
    def decode_prepare(self, tgt_slots: List[SlotBatch], enc: EncoderOut, max_len: int):
        """Decode-time constants: full-length self BiasSpec, cross bias and
        the KV cache. tgt_slots carry dummy (B, max_len) token values. Each
        layer's cross-attention K/V over the encoder output is projected
        here, once."""
        d = self.decoder_adaptor(tgt_slots)
        cb = self.cross_bias(d.pos_embed, enc.pos_embed)
        cfg = self.cfg
        B = enc.x.shape[0]
        cache = {}
        for i in range(cfg.decoder.layers):
            attn = getattr(self.decoder, f"layers_{i}").encoder_attn
            # the layer's own heads: a tensor-parallel shard holds its local ones
            H, head_dim = attn.num_heads, attn.head_dim
            cache[f"layers_{i}"] = {
                "self": MultiheadAttention.init_cache(B, max_len, H, head_dim, self.dtype, enc.x.device),
                "cross": {"k": attn.k_proj(enc.x).reshape(B, -1, H, head_dim),
                          "v": attn.v_proj(enc.x).reshape(B, -1, H, head_dim)},
            }
        return d.bias_spec, cb, cache

    def decode_step(self, tokens: torch.Tensor, step: int, enc: EncoderOut,
                    bias_spec: Optional[BiasSpec], cross_bias: Optional[torch.Tensor],
                    cache: Dict[str, Any], tgt_slot: SlotBatch,
                    noise_generator: Optional[torch.Generator] = None):
        """One decode step at absolute position ``step``: returns
        (output (B, S, ...), extra, new_cache). As in ofasys_tpu, a step
        passes no modality spans: under ``cfg.modal_ffn`` its FeedForwards
        take the plain pair (which an init from slot lists does not build).
        ``noise_generator``: the target adaptor's inference-time noise (the
        TTS prenet's dropout, which ofasys_tpu draws from the step's dropout
        rng); the step stays deterministic otherwise."""
        step_slot = dataclasses.replace(tgt_slot, value={"inputs": tokens, "pos_offset": step})
        d = self.decoder_adaptor([step_slot], noise_generator=noise_generator)
        x, new_cache = self.decoder(
            d.embed,
            enc.x,
            encoder_padding_mask=torch.logical_not(enc.padding_mask),
            self_bias_spec=bias_spec,
            cross_bias=cross_bias,
            cache=cache,
            cache_index=step,
        )
        out, extra = self.decoder_adaptor.forward_output(x, {}, [step_slot])
        return out, extra, new_cache


def _init_parameters(net: GeneralistNet, generator: torch.Generator):
    """flax's initializers: lecun-normal (truncated) Dense, PatchEmbed,
    Conv1d and ResNet kernels with zero bias, unit-scale zero-mean unit-var
    FrozenBatchNorms, normal(0.02) embeddings, type embedding
    and audio mask embedding, unit LayerNorms and head scales, zero
    relative-position tables."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, Dense):
                std = math.sqrt(1.0 / module.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                module.bias.zero_()
            elif isinstance(module, (PatchEmbed, Conv1d)):
                # lecun-normal over the fan-in: p * p * C of a patch, k * C of a window
                std = math.sqrt(1.0 / module.kernel[..., 0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(module.kernel, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 0.02, generator=generator)
        init_resnet_(net, generator)
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("type_embedding", "mask_emb"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "c_attn":
                p.fill_(1.0)
            elif leaf in ("rel_pos_table", "image_rel_pos_table"):
                p.zero_()
            elif leaf == "router":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf in ("moe_w1", "moe_w2"):
                # lecun-normal per expert: the fan-in is the input axis
                std = math.sqrt(1.0 / p.shape[-2]) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def modal_ids_of(sample_slots: Sequence) -> Dict[str, Tuple[int, ...]]:
    """The modality ids (``ModalityType.value - 1``, as every adaptor sets
    them) of the source and the target slots of one slot list or of a list
    of them, in first-seen order: {"encoder": ..., "decoder": ...}."""
    lists = (list(sample_slots) if isinstance(sample_slots[0], (list, tuple))
             else [sample_slots])
    ids: Dict[str, List[int]] = {"encoder": [], "decoder": []}
    for slots in lists:
        for s in slots:
            side = ids["encoder" if s.is_src else "decoder"]
            if s.modality.value - 1 not in side:
                side.append(s.modality.value - 1)
    return {k: tuple(v) for k, v in ids.items()}


def modal_ids_of_params(params: Dict[str, Any]) -> Dict[str, tuple]:
    """The modal_ffn expert ids of each stack, in the order the tree holds
    them (``<stack>/layers_0/ffn/experts_fc1_<id>``)."""
    out = {}
    for stack in ("encoder", "decoder"):
        ffn = params[stack]["layers_0"]["ffn"]
        out[stack] = tuple(int(k[len("experts_fc1_"):]) for k in ffn if k.startswith("experts_fc1_"))
    return out


@register_config("ofasys.model", "unify", GeneralistModelConfig)
class GeneralistModel:
    """User-facing model object.

    Lifecycle:
        model = GeneralistModel(arch="base")
        model.initialize(global_dict, active_adaptors=("text",), device="cuda", seed=0)
        logits, extra = model.apply(slots)
    """

    def __init__(self, cfg: Optional[GeneralistModelConfig] = None, arch: Optional[str] = None,
                 **kwargs):
        # deep copy: apply_arch/update mutate the config in place; the store's
        # node must survive one model's customization
        self.cfg = copy.deepcopy(cfg if cfg is not None
                                 else ConfigStore().get("ofasys.model", "unify").config)
        if arch:
            apply_arch(self.cfg, arch)
        if kwargs:
            self.cfg.update(**kwargs)
        self.net: Optional[GeneralistNet] = None
        self.global_dict = None

    def initialize(self, global_dict, active_adaptors: Tuple[str, ...] = ("text",),
                   dtype: torch.dtype = torch.bfloat16,
                   device: Union[str, torch.device] = "cuda", seed: int = 0,
                   adaptor_cfgs: Optional[Dict[str, Any]] = None,
                   sample_slots: Optional[Sequence] = None,
                   modal_ids: Optional[Dict[str, Tuple[int, ...]]] = None,
                   mesh=None):
        """Build the net once the vocab is final, with random parameters
        drawn from ``seed``, on ``device`` (raises when CUDA is requested
        and absent). ``adaptor_cfgs`` configures adaptors by name (e.g.
        ``{"image_resnet": ImageResnetAdaptorConfig(...)}``).

        ``sample_slots`` (one slot list, or one list per task), required
        under ``cfg.modal_ffn``: each stack gets an expert for every
        modality that a source (encoder) or target (decoder) slot of these
        lists has, as ofasys_tpu's ``init_params`` creates exactly those.

        ``mesh`` (parallel/mesh.py): the mesh that sequence and pipeline
        parallelism and expert-parallel MoE run over; the net's modules
        read it (``parallel.sharding.set_mesh``)."""
        dev = resolve_device(device)
        check_layout(self.cfg)
        if self.cfg.quant_training not in QUANT_TRAINING:
            raise ValueError(f"unknown quant_training {self.cfg.quant_training!r}; expected one of "
                             f"{QUANT_TRAINING}")
        if self.cfg.modal_ffn and modal_ids is None:
            if not sample_slots:
                raise ValueError("modal_ffn needs the sample slot lists that decide its experts")
            modal_ids = modal_ids_of(sample_slots)
        self.global_dict = global_dict
        net = GeneralistNet(self.cfg, vocab_size=len(global_dict), pad_id=global_dict.pad(),
                            active_adaptors=tuple(active_adaptors), dtype=dtype,
                            adaptor_cfgs=adaptor_cfgs, modal_ids=modal_ids)
        _init_parameters(net, torch.Generator().manual_seed(seed))
        self.net = net.to(dev).eval()
        if mesh is not None:
            from ofasys_torch.parallel.sharding import set_mesh

            set_mesh(self.net, mesh)
        return self

    @torch.no_grad()
    def apply(self, slots: List[SlotBatch], full_context: bool = False):
        if self.net is None:
            raise RuntimeError("call initialize(global_dict) first")
        return self.net(slots, full_context=full_context)

    def apply_train(self, slots: List[SlotBatch], deterministic: bool = False,
                    generator: Optional[torch.Generator] = None, full_context: bool = False,
                    hidden_only: bool = False, with_aux_losses: bool = False):
        """The forward with gradients (ofasys_tpu's ``apply(params, slots,
        deterministic, rngs)``): with ``deterministic=False`` and a
        ``generator`` on the net's device, dropout, DropPath and LayerDrop
        draw from it and ``quant_training='fwd'`` quantizes the stacks'
        projections; otherwise the forward is deterministic.
        ``hidden_only`` as in ``GeneralistNet.forward``."""
        if self.net is None:
            raise RuntimeError("call initialize(global_dict) first")
        if not with_aux_losses:
            return self.net(slots, full_context=full_context,
                            generator=None if deterministic else generator, hidden_only=hidden_only)
        moes = [m for m in self.net.modules() if isinstance(m, MoEFeedForward)]
        for m in moes:
            m.sink = []
        try:
            out, extra = self.net(slots, full_context=full_context,
                                  generator=None if deterministic else generator, hidden_only=hidden_only)
            leaves = [a for m in moes for a in m.sink]
        finally:
            for m in moes:
                m.sink = None
        aux = sum(leaves) if leaves else torch.zeros((), device=self.net.device)
        return out, extra, aux
