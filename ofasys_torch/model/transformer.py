"""Unified transformer encoder/decoder (counterpart of
ofasys_tpu/model/transformer.py, loop layout).

  * batch-major (B, T, E); parameters fp32, compute in the module dtype
    (bf16 on the card): every Dense casts its input, weight and bias to it.
  * LayerNorm statistics in fp32, eps 1e-5; exact (erf) GELU.
  * relative-position bias is gathered lazily per layer from a bucket
    matrix and stacked tables (:class:`BiasSpec`).
  * incremental decoding uses an explicit KV-cache dict.
  * normformer options: pre-LN, scale_attn, scale_fc, scale_heads,
    scale_resids; q-scaling (head_dim * attn_scale_factor) ** -0.5.
  * training mode: a ``generator`` (``torch.Generator`` on the activations'
    device) passed down from the step turns on residual, activation and
    attention dropout, DropPath and LayerDrop, as ``deterministic=False``
    with a dropout rng does in flax; ``generator=None`` is deterministic.

Submodule and parameter names follow the flax tree of ofasys_tpu
(``layers_0.self_attn.q_proj``, LayerNorm ``weight`` for flax ``scale``),
so utils/jax_params.load_jax_params maps one onto the other.

Int8 serving (``ops.quant.quantize_for_serving``: ``Dense`` and
``Embed.attend`` through kernel B7), int8 quantized training
(``cfg.quant_training='fwd'``: the attention projections and the FFN's
``fc1``/``fc2``, experts included, run ``ops.quant.int8_train_matmul``, kernel
B7, in training calls, the fused q/k/v as one call; the tied logits and the
adaptors stay in the compute dtype) and ``cfg.ln_impl`` (``make_ln``: the
LayerNorm kernels B6) follow ofasys_tpu's ``QuantDense``/``QuantEmbed`` and
``make_ln``; ``cfg.modal_ffn`` routes each modality's span through its own
FeedForward experts (:class:`FeedForward`). MoE, scan_layers, remat, ring attention and pipeline
parallelism wait for later slices (GeneralistModel.initialize raises when a
config asks for them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.ops.attention import causal_mask, combine_masks, dot_product_attention, dropout
from ofasys_torch.ops.dense_attention import dense_attention, dense_supported
from ofasys_torch.ops.flash_attention import flash_attention, flash_available, flash_supported
from ofasys_torch.ops.quant import int8_matmul, int8_train_matmul, is_quantized

LN_EPS = 1e-5


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``. After
    ``ops.quant.quantize_for_serving`` it holds int8 buffers ``q`` (out, in)
    and ``scale`` (out,) in place of its weight and runs ``int8_matmul`` in
    ``cfg.quant_mode``, read at call time (ofasys_tpu's ``QuantDense``);
    ``qtrain`` (a training call under quant_training='fwd') runs
    ``int8_train_matmul`` on the fp32 weight."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 cfg: GeneralistModelConfig):
        super().__init__(in_features, out_features)
        self.dtype = dtype
        self.cfg = cfg

    def forward(self, x: torch.Tensor, qtrain: bool = False) -> torch.Tensor:
        if is_quantized(self):
            y = int8_matmul(x, self.q, self.scale, mode=self.cfg.quant_mode, out_dtype=self.dtype)
            return y + self.bias.to(self.dtype)
        if qtrain:
            return int8_train_matmul(x.to(self.dtype), self.weight) + self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def qtrain_active(cfg: GeneralistModelConfig, generator: Optional[torch.Generator]) -> bool:
    """Quantized training runs in training calls (a ``generator``) under
    quant_training='fwd'; eval and decode calls stay in the compute dtype."""
    return generator is not None and cfg.quant_training == "fwd"


class Embed(nn.Embedding):
    """``nn.Embedding`` (fp32 table) whose ``attend`` is the tied output
    projection: ``query @ weight.T`` in ``dtype``, or, with an int8 attend
    table (``quantize_for_serving``), the w8a8 product through kernel B7
    (ofasys_tpu's ``QuantEmbed.attend``, which takes w8a8 whatever the mode)."""

    def attend(self, query: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if is_quantized(self):
            return int8_matmul(query, self.q, self.scale, mode="w8a8", out_dtype=query.dtype)
        return query.to(dtype) @ self.weight.to(dtype).t()


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics whose output is in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


def make_ln(cfg: GeneralistModelConfig, dim: int, dtype: torch.dtype) -> LayerNorm:
    """A LayerNorm of the stacks per ``cfg.ln_impl``: 'xla' the plain
    :class:`LayerNorm`, 'hybrid' (plain forward, kernel B6-bwd) and 'pallas'
    (kernels B6-fwd and B6-bwd) a ``FusedLayerNorm`` (ops/layer_norm.py). All
    three share parameter names and init."""
    impl = cfg.ln_impl
    if impl in ("hybrid", "pallas"):
        from ofasys_torch.ops.layer_norm import FusedLayerNorm

        return FusedLayerNorm(dim, dtype, mode="hybrid" if impl == "hybrid" else "fused")
    if impl != "xla":
        raise ValueError(f"unknown ln_impl {impl!r}; expected 'xla', 'hybrid' or 'pallas'")
    return LayerNorm(dim, dtype)


def get_activation_fn(name: str) -> Callable:
    if name == "gelu":
        return lambda x: F.gelu(x)
    if name in ("gelu_fast", "gelu_accurate"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "tanh":
        return torch.tanh
    if name == "linear":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


@dataclasses.dataclass
class BiasSpec:
    """Lazy self-attention bias: per-layer relative tables + shared absolute
    position bias.

    bucket: (T, T) int — indexes into the combined table's bucket axis
            (row 0 of the table is the zero/no-bias bucket).
    tables: (n_tables, n_buckets, H) — n_tables is 1 (shared) or n_layers.
    abs_bias: (B or 1, H, T, T) or None — abs-position q/k bias, layer-shared.
    """

    bucket: Optional[np.ndarray] = None
    tables: Optional[torch.Tensor] = None
    abs_bias: Optional[torch.Tensor] = None

    def __post_init__(self):
        self._stacked = None
        self._bucket_t = None

    def _bucket(self) -> torch.Tensor:
        if self._bucket_t is None:
            self._bucket_t = torch.as_tensor(np.asarray(self.bucket), dtype=torch.long,
                                             device=self.tables.device)
        return self._bucket_t

    def stacked(self) -> Optional[torch.Tensor]:
        """(n_tables, H, Tq, Tk) relative biases for every layer, gathered
        once per BiasSpec."""
        if self.tables is None or self.bucket is None:
            return None
        if self._stacked is None:
            self._stacked = self.tables[:, self._bucket()].permute(0, 3, 1, 2)
        return self._stacked

    def layer_bias(self, layer_idx: int) -> Optional[torch.Tensor]:
        """Additive bias for one layer, shape (B|1, H, Tq, Tk)."""
        out = None
        st = self.stacked()
        if st is not None:
            out = st[min(layer_idx, st.shape[0] - 1)][None]
        if self.abs_bias is not None:
            out = self.abs_bias if out is None else out + self.abs_bias
        return out

    def layer_bias_rows(self, layer_idx: int, start: int, size: int) -> Optional[torch.Tensor]:
        """Decode-path bias: only ``size`` query rows from ``start`` (clamped
        like a dynamic slice), (1, H, size, Tk)."""
        out = None
        if self.tables is not None and self.bucket is not None:
            bucket = self._bucket()
            start = max(0, min(start, bucket.shape[0] - size))
            rows = bucket[start:start + size]
            table = self.tables[min(layer_idx, self.tables.shape[0] - 1)]
            out = table[rows].permute(2, 0, 1)[None]
        if self.abs_bias is not None:
            start = max(0, min(start, self.abs_bias.shape[2] - size))
            ab = self.abs_bias[:, :, start:start + size]
            out = ab if out is None else out + ab
        return out


def attention_route(
    cfg: GeneralistModelConfig, device, B: int, Tq: int, Tk: int, num_heads: int,
    head_dim: int, dropout_rate: float, *, bias_shape: Optional[Tuple[int, ...]] = None,
    mask_shape: Optional[Tuple[int, ...]] = None, cached: bool = False,
) -> str:
    """Which attention a call of these shapes takes: 'flash' (kernels B3-B5),
    'dense' (B1/B2) or 'plain'. Flash is tried before the dense kernel, as
    in ofasys_tpu (T = 256 goes to flash); a KV-cached decode step, a mask
    that is not padding-only and attention dropout take neither kernel.
    ``bias_shape`` is (B|1, H, Tq, Tk), ``mask_shape`` (B|1, 1|H, Tq|1, Tk)."""
    padding_only = mask_shape is None or (len(mask_shape) == 4 and mask_shape[1] == 1
                                          and mask_shape[2] == 1)
    if (cfg.use_flash_attention and not cached and flash_available(device)
            and flash_supported(Tq, Tk, head_dim, dropout_rate) and padding_only):
        return "flash"
    if (cfg.attn_kernel in ("auto", "pallas") and not cached
            and (torch.device(device).type == "cuda" or cfg.attn_kernel == "pallas")
            and dense_supported(B, Tq, Tk, head_dim, num_heads, dropout_rate)
            and (bias_shape is None
                 or (len(bias_shape) == 4 and bias_shape[0] == 1
                     and tuple(bias_shape[2:]) == (Tq, Tk)))
            and (mask_shape is None
                 or (padding_only and mask_shape[0] in (1, B) and mask_shape[3] == Tk))):
        return "dense"
    return "plain"


class MultiheadAttention(nn.Module):
    """QKV attention with additive bias, per-head output scaling and an
    explicit KV cache. Reads ``attn_kernel``, ``attn_logits``, ``fuse_qkv``
    and ``use_flash_attention`` from the shared config at call time."""

    def __init__(self, cfg: GeneralistModelConfig, embed_dim: int, num_heads: int,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.q_proj = Dense(embed_dim, embed_dim, dtype, cfg)
        self.k_proj = Dense(embed_dim, embed_dim, dtype, cfg)
        self.v_proj = Dense(embed_dim, embed_dim, dtype, cfg)
        self.out_proj = Dense(embed_dim, embed_dim, dtype, cfg)
        if cfg.scale_heads:
            self.c_attn = nn.Parameter(torch.ones(num_heads))

    def _proj(self, mods, x, qtrain: bool = False):
        """Projections of one input; with fuse_qkv they run as one GEMM over
        the concatenated weights (parameter layout unchanged). Int8 serving
        keeps per-projection scales and no fp32 weight: one call each. Under
        ``qtrain`` the concatenated fp32 weight goes through one
        ``int8_train_matmul``: its per-output-channel scales are those of the
        parts, so the result equals separate calls bit for bit."""
        if len(mods) == 1 or not self.cfg.fuse_qkv or any(is_quantized(m) for m in mods):
            return [m(x, qtrain) for m in mods]
        b = torch.cat([m.bias for m in mods]).to(self.dtype)
        if qtrain:
            w = torch.cat([m.weight for m in mods], dim=0)
            y = int8_train_matmul(x.to(self.dtype), w) + b
        else:
            w = torch.cat([m.weight for m in mods], dim=0).to(self.dtype)
            y = F.linear(x.to(self.dtype), w, b)
        return list(torch.chunk(y, len(mods), dim=-1))

    @staticmethod
    def init_cache(batch: int, max_len: int, num_heads: int, head_dim: int,
                   dtype: torch.dtype, device) -> Dict[str, Any]:
        return {
            "k": torch.zeros((batch, max_len, num_heads, head_dim), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, num_heads, head_dim), dtype=dtype, device=device),
            "index": 0,
        }

    def forward(
        self,
        query: torch.Tensor,                       # (B, Tq, E)
        key_value: Optional[torch.Tensor] = None,  # (B, Tk, E); None = self-attn
        *,
        bias: Optional[torch.Tensor] = None,       # additive (B|1, H, Tq, Tk)
        mask: Optional[torch.Tensor] = None,       # bool keep-mask (B|1, 1|H, Tq, Tk)
        causal: bool = False,
        cache: Optional[Dict[str, Any]] = None,
        static_kv: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        cfg = self.cfg
        H = self.num_heads
        head_dim = self.embed_dim // H
        scaling = float(head_dim * cfg.attn_scale_factor) ** -0.5
        B, Tq = query.shape[:2]
        qtrain = qtrain_active(cfg, generator)
        if cache is not None and static_kv:
            # cross-attention at decode time: k/v computed once, reused
            q = self.q_proj(query).reshape(B, Tq, H, head_dim)
            k, v = cache["k"], cache["v"]
        else:
            if key_value is None:
                q, k, v = self._proj([self.q_proj, self.k_proj, self.v_proj], query, qtrain)
                Tk = Tq
            else:
                q = self.q_proj(query, qtrain)
                k, v = self._proj([self.k_proj, self.v_proj], key_value, qtrain)
                Tk = key_value.shape[1]
            q = q.reshape(B, Tq, H, head_dim)
            k = k.reshape(B, Tk, H, head_dim)
            v = v.reshape(B, Tk, H, head_dim)
            if cache is not None:
                # incremental self-attention: write the new step(s) at the
                # cache index in place; rows past each query's own step are
                # masked out (multi-token steps stay causal within themselves)
                idx = cache["index"]
                cache["k"][:, idx:idx + Tq] = k.to(cache["k"].dtype)
                cache["v"][:, idx:idx + Tq] = v.to(cache["v"].dtype)
                k, v = cache["k"], cache["v"]
                cache = {"k": k, "v": v, "index": idx + Tq}
                Tk = k.shape[1]
                row_limit = idx + 1 + torch.arange(Tq, device=q.device)[:, None]
                valid = (torch.arange(Tk, device=q.device)[None, :] < row_limit)[None, None]
                mask = valid if mask is None else torch.logical_and(mask, valid)

        # attention-probability dropout, live only in training mode; both
        # kernel gates refuse a nonzero rate
        p_drop = cfg.attention_dropout if generator is not None else 0.0
        Tq_, Tk_ = q.shape[1], k.shape[1]
        route = attention_route(
            cfg, q.device, B, Tq_, Tk_, H, head_dim, p_drop,
            bias_shape=None if bias is None else tuple(bias.shape),
            mask_shape=None if mask is None else tuple(mask.shape),
            cached=cache is not None,
        )
        if route == "flash":
            x = flash_attention(q, k, v, bias=bias, mask=mask, scale=scaling,
                                causal=causal).to(self.dtype)
        elif route == "dense":
            x = dense_attention(q, k, v, bias=bias, mask=mask, scale=scaling,
                                causal=causal).to(self.dtype)
        else:
            eff_mask = combine_masks(mask, causal_mask(Tq_, Tk_, q.device) if causal else None)
            x = dot_product_attention(
                q, k, v, bias=bias, mask=eff_mask, scale=scaling,
                dropout_rate=p_drop, generator=generator, dtype=self.dtype,
                logits_dtype=self.dtype if cfg.attn_logits == "compute" else None,
            )
        if cfg.scale_heads:
            x = x * self.c_attn.to(self.dtype)[None, None, :, None]
        x = self.out_proj(x.reshape(B, Tq, self.embed_dim), qtrain)
        return x, cache


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth on a residual branch (ofasys_tpu's ``DropPath``):
    one keep draw per sample, kept samples scaled by ``1 / (1 - rate)``."""
    return dropout(x, rate, generator, shape=(x.shape[0],) + (1,) * (x.dim() - 1))


def layer_drop(y: torch.Tensor, x: torch.Tensor, rate: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """LayerDrop: the layer's output ``y`` is replaced by its input ``x``
    with probability ``rate`` (one draw, on the device, no host sync)."""
    if rate <= 0.0 or generator is None:
        return y
    keep = torch.rand((), generator=generator, device=y.device) < 1.0 - rate
    return torch.where(keep, y, x)


class FeedForward(nn.Module):
    """FFN with optional mid-LN (scale_fc) and activation dropout.

    ``modal_ids`` None: the plain ``fc1``/``fc2``. A tuple (``cfg.modal_ffn``):
    one expert pair ``experts_fc1_{id}``/``experts_fc2_{id}`` (and
    ``experts_fc2_{id}_ln``) per modality id, and no plain pair, as
    ofasys_tpu's tree holds after an init whose every call passed spans.
    Each (start, end, modal_id) span of ``modal_spans`` runs through its
    modality's expert and the results are concatenated; a call without
    spans needs the plain pair and raises where it is missing, as
    ofasys_tpu's apply does."""

    def __init__(self, cfg: GeneralistModelConfig, ffn_dim: int, embed_dim: int,
                 dtype: torch.dtype, modal_ids: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.cfg = cfg
        self.act = get_activation_fn(cfg.activation_fn)
        self.modal_ids = None if modal_ids is None else tuple(modal_ids)
        names = ([("fc1", "fc2")] if modal_ids is None
                 else [(f"experts_fc1_{i}", f"experts_fc2_{i}") for i in self.modal_ids])
        for fc1, fc2 in names:
            self.add_module(fc1, Dense(embed_dim, ffn_dim, dtype, cfg))
            self.add_module(fc2, Dense(ffn_dim, embed_dim, dtype, cfg))
            self.add_module(fc2 + "_ln", make_ln(cfg, ffn_dim, dtype) if cfg.scale_fc else None)

    def _run(self, x: torch.Tensor, fc1: str, fc2: str,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if not hasattr(self, fc1):
            raise LookupError(
                f"FeedForward has no {fc1!r}: its parameters are {sorted(n for n, _ in self.named_children())} "
                "(under modal_ffn only the experts of the initialized modalities exist)")
        qtrain = qtrain_active(self.cfg, generator)
        h = self.act(getattr(self, fc1)(x, qtrain))
        h = dropout(h, self.cfg.activation_dropout, generator)
        ln = getattr(self, fc2 + "_ln")
        if ln is not None:
            h = ln(h)
        return getattr(self, fc2)(h, qtrain)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                modal_spans: Optional[Tuple[Tuple[int, int, int], ...]] = None) -> torch.Tensor:
        if not self.cfg.modal_ffn or not modal_spans:
            return self._run(x, "fc1", "fc2", generator)
        return torch.cat([self._run(x[:, start:end], f"experts_fc1_{m}", f"experts_fc2_{m}", generator)
                          for start, end, m in modal_spans], dim=1)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN encoder block with normformer extras."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype,
                 modal_ids: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.cfg = cfg
        E = cfg.encoder.embed_dim
        self.self_attn_layer_norm = make_ln(cfg, E, dtype)
        self.self_attn = MultiheadAttention(cfg, E, cfg.encoder.attention_heads, dtype)
        self.attn_ln = make_ln(cfg, E, dtype) if cfg.scale_attn else None
        self.final_layer_norm = make_ln(cfg, E, dtype)
        self.ffn = FeedForward(cfg, cfg.encoder.ffn_embed_dim, E, dtype, modal_ids)
        if cfg.scale_resids:
            self.w_resid = nn.Parameter(torch.ones(E))
        self.dtype = dtype

    def forward(self, x, mask=None, bias=None, generator=None, drop_path_rate: float = 0.0,
                modal_spans=None):
        cfg = self.cfg
        pre = cfg.encoder.normalize_before
        residual = x
        h = self.self_attn_layer_norm(x) if pre else x
        h, _ = self.self_attn(h, bias=bias, mask=mask, generator=generator)
        if self.attn_ln is not None:
            h = self.attn_ln(h)
        h = dropout(h, cfg.dropout, generator)
        x = residual + drop_path(h, drop_path_rate, generator)
        if not pre:
            x = self.self_attn_layer_norm(x)

        residual = x
        h = self.final_layer_norm(x) if pre else x
        h = self.ffn(h, generator, modal_spans)
        h = dropout(h, cfg.dropout, generator)
        if cfg.scale_resids:
            residual = residual * self.w_resid.to(self.dtype)
        x = residual + drop_path(h, drop_path_rate, generator)
        if not pre:
            x = self.final_layer_norm(x)
        return x


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder block: causal self-attention + cross-attention + FFN."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype,
                 modal_ids: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.cfg = cfg
        E = cfg.decoder.embed_dim
        H = cfg.decoder.attention_heads
        self.self_attn_layer_norm = make_ln(cfg, E, dtype)
        self.self_attn = MultiheadAttention(cfg, E, H, dtype)
        self.self_attn_ln = make_ln(cfg, E, dtype) if cfg.scale_attn else None
        self.encoder_attn_layer_norm = make_ln(cfg, E, dtype)
        self.encoder_attn = MultiheadAttention(cfg, E, H, dtype)
        self.cross_attn_ln = make_ln(cfg, E, dtype) if cfg.scale_attn else None
        self.final_layer_norm = make_ln(cfg, E, dtype)
        self.ffn = FeedForward(cfg, cfg.decoder.ffn_embed_dim, E, dtype, modal_ids)
        if cfg.scale_resids:
            self.w_resid = nn.Parameter(torch.ones(E))
        self.dtype = dtype

    def forward(self, x, encoder_out=None, self_mask=None, self_bias=None, cross_mask=None,
                cross_bias=None, cache=None, full_context: bool = False, generator=None,
                drop_path_rate: float = 0.0, modal_spans=None):
        cfg = self.cfg
        pre = cfg.decoder.normalize_before
        new_cache: Dict[str, Any] = {}

        residual = x
        h = self.self_attn_layer_norm(x) if pre else x
        h, self_kv = self.self_attn(
            h, bias=self_bias, mask=self_mask, causal=(cache is None and not full_context),
            cache=None if cache is None else cache["self"], generator=generator,
        )
        if cache is not None:
            new_cache["self"] = self_kv
        if self.self_attn_ln is not None:
            h = self.self_attn_ln(h)
        h = dropout(h, cfg.dropout, generator)
        x = residual + drop_path(h, drop_path_rate, generator)
        if not pre:
            x = self.self_attn_layer_norm(x)

        if encoder_out is not None:
            residual = x
            h = self.encoder_attn_layer_norm(x) if pre else x
            h, _ = self.encoder_attn(
                h, encoder_out, bias=cross_bias, mask=cross_mask,
                cache=None if cache is None else cache.get("cross"), static_kv=True,
                generator=generator,
            )
            if cache is not None and "cross" in cache:
                new_cache["cross"] = cache["cross"]
            if self.cross_attn_ln is not None:
                h = self.cross_attn_ln(h)
            h = dropout(h, cfg.dropout, generator)
            x = residual + drop_path(h, drop_path_rate, generator)
            if not pre:
                x = self.encoder_attn_layer_norm(x)

        residual = x
        h = self.final_layer_norm(x) if pre else x
        h = self.ffn(h, generator, modal_spans)
        h = dropout(h, cfg.dropout, generator)
        if cfg.scale_resids:
            residual = residual * self.w_resid.to(self.dtype)
        x = residual + drop_path(h, drop_path_rate, generator)
        if not pre:
            x = self.final_layer_norm(x)
        return x, (new_cache if cache is not None else None)


class TransformerEncoder(nn.Module):
    """Layer stack over already-adapted embeddings. ``modal_ids``: the
    experts of every layer's FeedForward under ``cfg.modal_ffn``."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype,
                 modal_ids: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.encoder.layers
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", TransformerEncoderLayer(cfg, dtype, modal_ids))
        self.layer_norm = make_ln(cfg, cfg.encoder.embed_dim, dtype) if cfg.encoder.normalize_before else None

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor,
                bias_spec: Optional[BiasSpec] = None,
                generator: Optional[torch.Generator] = None,
                modal_spans: Optional[Tuple[Tuple[int, int, int], ...]] = None) -> torch.Tensor:
        """x (B, T, E) adapted embeddings; padding_mask (B, T) True = valid;
        ``generator`` turns on training mode (module docstring);
        ``modal_spans`` route the FeedForwards under ``cfg.modal_ffn``."""
        attn_mask = padding_mask[:, None, None, :]
        dpr = np.linspace(0.0, self.cfg.encode_drop_path_rate, self.n_layers)
        for i in range(self.n_layers):
            bias = bias_spec.layer_bias(i) if bias_spec is not None else None
            y = getattr(self, f"layers_{i}")(x, attn_mask, bias, generator, float(dpr[i]), modal_spans)
            x = layer_drop(y, x, self.cfg.encoder.layerdrop, generator)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x


class TransformerDecoder(nn.Module):
    """Decoder stack; full-sequence and incremental (KV cache) modes."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype,
                 modal_ids: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.decoder.layers
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", TransformerDecoderLayer(cfg, dtype, modal_ids))
        self.layer_norm = make_ln(cfg, cfg.decoder.embed_dim, dtype) if cfg.decoder.normalize_before else None

    def forward(
        self,
        x: torch.Tensor,                       # (B, Tt, E) adapted target embeddings
        encoder_out: Optional[torch.Tensor],   # (B, Ts, E)
        *,
        self_padding_mask: Optional[torch.Tensor] = None,     # (B, Tt) True = valid
        encoder_padding_mask: Optional[torch.Tensor] = None,  # (B, Ts) True = valid
        self_bias_spec: Optional[BiasSpec] = None,
        cross_bias: Optional[torch.Tensor] = None,            # (B|1, H, Tt, Ts)
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
        full_context: bool = False,
        generator: Optional[torch.Generator] = None,
        modal_spans: Optional[Tuple[Tuple[int, int, int], ...]] = None,
    ):
        Tt = x.shape[1]
        self_mask = None
        if cache is None and self_padding_mask is not None:
            self_mask = self_padding_mask[:, None, None, :]
        cross_mask = None
        if encoder_padding_mask is not None:
            cross_mask = encoder_padding_mask[:, None, None, :]

        new_cache: Optional[Dict[str, Any]] = {} if cache is not None else None
        dpr = np.linspace(0.0, self.cfg.decode_drop_path_rate, self.n_layers)
        for i in range(self.n_layers):
            self_bias = None
            if self_bias_spec is not None:
                self_bias = (self_bias_spec.layer_bias(i) if cache is None
                             else self_bias_spec.layer_bias_rows(i, cache_index, Tt))
            cb = cross_bias
            if cb is not None and cache is not None:
                start = max(0, min(cache_index, cb.shape[2] - Tt))
                cb = cb[:, :, start:start + Tt]
            y, layer_cache = getattr(self, f"layers_{i}")(
                x, encoder_out, self_mask, self_bias, cross_mask, cb,
                None if cache is None else cache[f"layers_{i}"], full_context,
                generator, float(dpr[i]), modal_spans,
            )
            # LayerDrop (never during incremental decoding)
            x = y if cache is not None else layer_drop(y, x, self.cfg.decoder.layerdrop, generator)
            if cache is not None:
                new_cache[f"layers_{i}"] = layer_cache
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x, new_cache
