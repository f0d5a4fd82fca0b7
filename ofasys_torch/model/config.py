"""GeneralistModel configuration + arch presets (counterpart of
ofasys_tpu/model/config.py, every default kept).

Plain dataclasses (the ConfigStore holds one as ``ofasys.model/unify``).
``GeneralistModel.initialize`` holds the layer-layout options to
ofasys_tpu's guards (:func:`check_layout`: pipeline stages need the stacked
layout, which refuses LayerDrop and MoE, and sequence parallelism does not
pipeline) and raises when ``quant_training`` is neither 'none' nor 'fwd'.
``scan_layers`` selects the stacked parameter layout of the trees that go
in and out (``layers_scan/layer/<leaf>`` with a leading layer axis,
utils/jax_params.py); the modules stay one per layer. ``ln_impl`` is checked where the stacks build
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
    # per-layer activation checkpointing in training: 'none', 'full' or
    # 'dots' (model/transformer.remat_call)
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

REMAT_MODES = ("none", "full", "dots")


def check_layout(cfg: GeneralistModelConfig):
    """ofasys_tpu's ``GeneralistModel.initialize`` guards on the layer
    layout, and the remat mode."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {cfg.remat!r}; expected 'none', 'full' or 'dots'")
    if cfg.pipeline_stages > 1 and not cfg.scan_layers:
        raise ValueError("pipeline_stages > 1 requires scan_layers=True (stacked layer params)")
    if cfg.scan_layers and (cfg.encoder.layerdrop > 0.0 or cfg.decoder.layerdrop > 0.0):
        raise ValueError(
            "layerdrop requires the loop layer layout (scan_layers=False): "
            "nn.scan shares one compiled body across layers"
        )
    if cfg.scan_layers and cfg.moe_experts > 0:
        raise ValueError(
            "moe_experts requires the loop layer layout (scan_layers=False): "
            "MoE layers have different params than dense layers, which "
            "breaks nn.scan's homogeneous stacked-parameter structure"
        )
    if cfg.pipeline_stages > 1 and cfg.sequence_parallel:
        raise ValueError("sequence_parallel cannot be combined with pipeline_stages > 1")
