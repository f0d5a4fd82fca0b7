"""GeneralistModel configuration + arch presets (counterpart of
ofasys_tpu/model/config.py, every default kept).

Plain dataclasses (the ConfigStore holds one as ``ofasys.model/unify``).
Fields that name execution features the port does not run yet (MoE, scan-over-layers,
pipeline and sequence parallelism, remat) stay so that a config carried
over from ofasys_tpu keeps its shape; ``GeneralistModel.initialize`` raises
when one is set away from its default, and when ``quant_training`` is
neither 'none' nor 'fwd'. ``ln_impl`` is checked where the stacks build
their LayerNorms (``model/transformer.make_ln``) and ``quant_mode`` where
an int8 matmul runs (``ops/quant.int8_matmul``), as in ofasys_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TransformerStackConfig:
    embed_dim: int = 256
    ffn_embed_dim: int = 1024
    layers: int = 4
    attention_heads: int = 4
    normalize_before: bool = True
    layerdrop: float = 0.0


@dataclass
class GeneralistModelConfig:
    arch: str = "tiny"
    encoder: TransformerStackConfig = field(default_factory=TransformerStackConfig)
    decoder: TransformerStackConfig = field(default_factory=TransformerStackConfig)

    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation_fn: str = "gelu"

    max_source_positions: int = 1024
    max_target_positions: int = 1024

    no_scale_embedding: bool = True
    layernorm_embedding: bool = True
    add_type_embedding: bool = True
    entangle_position_embedding: bool = False

    attn_scale_factor: float = 2.0
    scale_attn: bool = True
    scale_fc: bool = True
    scale_heads: bool = True
    scale_resids: bool = False

    use_self_attn_bias: bool = True
    share_attn_bias: bool = False
    modal_ffn: bool = False

    encode_drop_path_rate: float = 0.0
    decode_drop_path_rate: float = 0.0

    # blocked flash attention (kernels B3-B5, ops/flash_attention.py) for
    # Tk >= 256 on CUDA tensors; the CPU takes the plain path
    use_flash_attention: bool = True
    # LayerNorm of the stacks (model/transformer.make_ln): 'xla' plain,
    # 'hybrid' plain forward + kernel B6-bwd, 'pallas' kernels B6-fwd and
    # B6-bwd (ops/layer_norm.py); the adaptor LayerNorms stay plain
    ln_impl: str = "xla"
    # dtype of the materialized (B,H,Tq,Tk) scores on the plain path:
    #   'compute' — scores rounded to the compute dtype, softmax in fp32
    #               over the rounded values; 'fp32' — full precision
    attn_logits: str = "compute"
    # q/k/v projections of one input as one GEMM (parameter layout unchanged)
    fuse_qkv: bool = True
    # carried over from ofasys_tpu configs; eager PyTorch has no layout
    # assignment to steer, so it changes nothing here
    attn_layout: str = "bhtd"
    # dense-attention kernel B1 (ops/dense_attention.py):
    #   'auto'   — on CUDA tensors when the gate passes; plain path otherwise
    #   'xla'    — never (plain attention)
    #   'pallas' — same gate, and on the CPU too through B1's plain version
    attn_kernel: str = "auto"
    remat: str = "none"
    scan_layers: bool = False
    moe_experts: int = 0
    moe_every_n: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    sequence_parallel: bool = False
    # int8 serving after OFASys.quantize() (ops/quant.py): 'w8a8' (kernel B7)
    # or 'w8' (dequantize, plain matmul)
    quant_mode: str = "w8a8"
    # int8 quantized training: 'none' or 'fwd' (the stacks' projections run
    # ops/quant.int8_train_matmul, kernel B7, in training calls only)
    quant_training: str = "none"

    def __post_init__(self):
        # apply the arch preset only when the stacks are untouched defaults
        if self.arch and self.encoder == TransformerStackConfig() and self.decoder == TransformerStackConfig():
            apply_arch(self, self.arch)

    def update(self, **kwargs):
        """Set fields by name; a dotted name (``encoder.layers``) reaches
        into a stack's config, as ofasys_tpu's ``update`` does."""
        from ofasys_torch.configure.config_store import update_config

        return update_config(self, **kwargs)


_ARCH_TABLE = {
    # name: (embed_dim, ffn_dim, enc_layers, dec_layers, heads)
    "tiny": (256, 4 * 256, 4, 4, 4),
    "medium": (512, 4 * 512, 4, 4, 8),
    "base": (768, 4 * 768, 6, 6, 12),
    "large": (1024, 4 * 1024, 12, 12, 16),
    "huge": (1280, 4 * 1280, 24, 12, 16),
    "asr_small": (256, 2048, 12, 6, 4),
    "asr_base": (768, 4 * 768, 12, 6, 12),
    "6b": (2560, 4 * 2560, 36, 24, 32),
    "8b": (2560, 4 * 2560, 48, 36, 32),
    "10b": (2816, 4 * 2816, 48, 36, 32),
}


def apply_arch(cfg: GeneralistModelConfig, arch: str):
    if arch not in _ARCH_TABLE:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(_ARCH_TABLE)}")
    dim, ffn, enc_l, dec_l, heads = _ARCH_TABLE[arch]
    cfg.arch = arch
    cfg.encoder.embed_dim = cfg.decoder.embed_dim = dim
    cfg.encoder.ffn_embed_dim = cfg.decoder.ffn_embed_dim = ffn
    cfg.encoder.layers = enc_l
    cfg.decoder.layers = dec_l
    cfg.encoder.attention_heads = cfg.decoder.attention_heads = heads
    return cfg


QUANT_TRAINING = ("none", "fwd")

# fields whose non-default values select code this slice does not port,
# with where each waits
UNPORTED_DEFAULTS = {
    "scan_layers": (False, "Queue A item 13"),
    "moe_experts": (0, "Queue A item 13"),
    "pipeline_stages": (1, "Queue A item 13"),
    "sequence_parallel": (False, "Queue A item 13"),
    # per-layer activation checkpointing; torch.utils.checkpoint with the
    # step's generator draws replayed comes with the parallelism item
    "remat": ("none", "Queue A item 13"),
}
