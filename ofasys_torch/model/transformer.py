"""Unified transformer encoder/decoder (counterpart of
ofasys_tpu/model/transformer.py, loop layout, inference).

  * batch-major (B, T, E); parameters fp32, compute in the module dtype
    (bf16 on the card): every Dense casts its input, weight and bias to it.
  * LayerNorm statistics in fp32, eps 1e-5; exact (erf) GELU.
  * relative-position bias is gathered lazily per layer from a bucket
    matrix and stacked tables (:class:`BiasSpec`).
  * incremental decoding uses an explicit KV-cache dict.
  * normformer options: pre-LN, scale_attn, scale_fc, scale_heads,
    scale_resids; q-scaling (head_dim * attn_scale_factor) ** -0.5.

Submodule and parameter names follow the flax tree of ofasys_tpu
(``layers_0.self_attn.q_proj``, LayerNorm ``weight`` for flax ``scale``),
so utils/jax_params.load_jax_params maps one onto the other.

MoE, scan_layers, remat, ring attention and pipeline parallelism wait for
later slices (GeneralistModel.initialize raises when a config asks for them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.ops.attention import causal_mask, combine_masks, dot_product_attention
from ofasys_torch.ops.dense_attention import dense_attention, dense_supported

LN_EPS = 1e-5


def flash_supported(Tq: int, Tk: int, D: int, dropout_rate: float) -> bool:
    """Shapes that ofasys_tpu sends to its flash kernel (B3)."""
    if dropout_rate > 0.0 or D > 256:
        return False
    return Tq >= 16 and Tk >= 256


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class Embed(nn.Embedding):
    """``nn.Embedding`` (fp32 table) whose ``attend`` is the tied output
    projection: ``query @ weight.T`` in ``dtype``."""

    def attend(self, query: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return query.to(dtype) @ self.weight.to(dtype).t()


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics whose output is in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


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
        self.q_proj = Dense(embed_dim, embed_dim, dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype)
        if cfg.scale_heads:
            self.c_attn = nn.Parameter(torch.ones(num_heads))

    def _proj(self, mods, x):
        """Projections of one input; with fuse_qkv they run as one GEMM over
        the concatenated weights (parameter layout unchanged)."""
        if len(mods) == 1 or not self.cfg.fuse_qkv:
            return [m(x) for m in mods]
        w = torch.cat([m.weight for m in mods], dim=0).to(self.dtype)
        b = torch.cat([m.bias for m in mods]).to(self.dtype)
        return list(torch.chunk(F.linear(x.to(self.dtype), w, b), len(mods), dim=-1))

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
    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
        cfg = self.cfg
        H = self.num_heads
        head_dim = self.embed_dim // H
        scaling = float(head_dim * cfg.attn_scale_factor) ** -0.5
        B, Tq = query.shape[:2]
        if cache is not None and static_kv:
            # cross-attention at decode time: k/v computed once, reused
            q = self.q_proj(query).reshape(B, Tq, H, head_dim)
            k, v = cache["k"], cache["v"]
        else:
            if key_value is None:
                q, k, v = self._proj([self.q_proj, self.k_proj, self.v_proj], query)
                Tk = Tq
            else:
                q = self.q_proj(query)
                k, v = self._proj([self.k_proj, self.v_proj], key_value)
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

        Tq_, Tk_ = q.shape[1], k.shape[1]
        padding_only = mask is None or (mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)
        if (cfg.use_flash_attention and cache is None and q.is_cuda
                and flash_supported(Tq_, Tk_, head_dim, 0.0) and padding_only):
            raise NotImplementedError(
                f"attention with Tq={Tq_}, Tk={Tk_} belongs to the flash kernel B3 "
                "(ofasys_tpu/ops/pallas_attention.py), which is not ported to CUDA yet; "
                "keep sequences below 256 tokens"
            )
        dense_ok = (
            cfg.attn_kernel in ("auto", "pallas")
            and cache is None
            and (q.is_cuda or cfg.attn_kernel == "pallas")
            and dense_supported(B, Tq_, Tk_, head_dim, H, 0.0)
            and (bias is None
                 or (bias.dim() == 4 and bias.shape[0] == 1
                     and bias.shape[2] == Tq_ and bias.shape[3] == Tk_))
            and (mask is None
                 or (mask.dim() == 4 and mask.shape[0] in (1, B)
                     and mask.shape[1] == 1 and mask.shape[2] == 1
                     and mask.shape[3] == Tk_))
        )
        if dense_ok:
            x = dense_attention(q, k, v, bias=bias, mask=mask, scale=scaling,
                                causal=causal).to(self.dtype)
        else:
            eff_mask = combine_masks(mask, causal_mask(Tq_, Tk_, q.device) if causal else None)
            x = dot_product_attention(
                q, k, v, bias=bias, mask=eff_mask, scale=scaling, dtype=self.dtype,
                logits_dtype=self.dtype if cfg.attn_logits == "compute" else None,
            )
        if cfg.scale_heads:
            x = x * self.c_attn.to(self.dtype)[None, None, :, None]
        x = self.out_proj(x.reshape(B, Tq, self.embed_dim))
        return x, cache


class FeedForward(nn.Module):
    """FFN with optional mid-LN (scale_fc)."""

    def __init__(self, cfg: GeneralistModelConfig, ffn_dim: int, embed_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.act = get_activation_fn(cfg.activation_fn)
        self.fc1 = Dense(embed_dim, ffn_dim, dtype)
        self.fc2 = Dense(ffn_dim, embed_dim, dtype)
        self.fc2_ln = LayerNorm(ffn_dim, dtype) if cfg.scale_fc else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.fc1(x))
        if self.fc2_ln is not None:
            h = self.fc2_ln(h)
        return self.fc2(h)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN encoder block with normformer extras."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        E = cfg.encoder.embed_dim
        self.self_attn_layer_norm = LayerNorm(E, dtype)
        self.self_attn = MultiheadAttention(cfg, E, cfg.encoder.attention_heads, dtype)
        self.attn_ln = LayerNorm(E, dtype) if cfg.scale_attn else None
        self.final_layer_norm = LayerNorm(E, dtype)
        self.ffn = FeedForward(cfg, cfg.encoder.ffn_embed_dim, E, dtype)
        if cfg.scale_resids:
            self.w_resid = nn.Parameter(torch.ones(E))
        self.dtype = dtype

    def forward(self, x, mask=None, bias=None):
        pre = self.cfg.encoder.normalize_before
        residual = x
        h = self.self_attn_layer_norm(x) if pre else x
        h, _ = self.self_attn(h, bias=bias, mask=mask)
        if self.attn_ln is not None:
            h = self.attn_ln(h)
        x = residual + h
        if not pre:
            x = self.self_attn_layer_norm(x)

        residual = x
        h = self.final_layer_norm(x) if pre else x
        h = self.ffn(h)
        if self.cfg.scale_resids:
            residual = residual * self.w_resid.to(self.dtype)
        x = residual + h
        if not pre:
            x = self.final_layer_norm(x)
        return x


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder block: causal self-attention + cross-attention + FFN."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        E = cfg.decoder.embed_dim
        H = cfg.decoder.attention_heads
        self.self_attn_layer_norm = LayerNorm(E, dtype)
        self.self_attn = MultiheadAttention(cfg, E, H, dtype)
        self.self_attn_ln = LayerNorm(E, dtype) if cfg.scale_attn else None
        self.encoder_attn_layer_norm = LayerNorm(E, dtype)
        self.encoder_attn = MultiheadAttention(cfg, E, H, dtype)
        self.cross_attn_ln = LayerNorm(E, dtype) if cfg.scale_attn else None
        self.final_layer_norm = LayerNorm(E, dtype)
        self.ffn = FeedForward(cfg, cfg.decoder.ffn_embed_dim, E, dtype)
        if cfg.scale_resids:
            self.w_resid = nn.Parameter(torch.ones(E))
        self.dtype = dtype

    def forward(self, x, encoder_out=None, self_mask=None, self_bias=None, cross_mask=None,
                cross_bias=None, cache=None, full_context: bool = False):
        pre = self.cfg.decoder.normalize_before
        new_cache: Dict[str, Any] = {}

        residual = x
        h = self.self_attn_layer_norm(x) if pre else x
        h, self_kv = self.self_attn(
            h, bias=self_bias, mask=self_mask, causal=(cache is None and not full_context),
            cache=None if cache is None else cache["self"],
        )
        if cache is not None:
            new_cache["self"] = self_kv
        if self.self_attn_ln is not None:
            h = self.self_attn_ln(h)
        x = residual + h
        if not pre:
            x = self.self_attn_layer_norm(x)

        if encoder_out is not None:
            residual = x
            h = self.encoder_attn_layer_norm(x) if pre else x
            h, _ = self.encoder_attn(
                h, encoder_out, bias=cross_bias, mask=cross_mask,
                cache=None if cache is None else cache.get("cross"), static_kv=True,
            )
            if cache is not None and "cross" in cache:
                new_cache["cross"] = cache["cross"]
            if self.cross_attn_ln is not None:
                h = self.cross_attn_ln(h)
            x = residual + h
            if not pre:
                x = self.encoder_attn_layer_norm(x)

        residual = x
        h = self.final_layer_norm(x) if pre else x
        h = self.ffn(h)
        if self.cfg.scale_resids:
            residual = residual * self.w_resid.to(self.dtype)
        x = residual + h
        if not pre:
            x = self.final_layer_norm(x)
        return x, (new_cache if cache is not None else None)


class TransformerEncoder(nn.Module):
    """Layer stack over already-adapted embeddings."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.encoder.layers
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", TransformerEncoderLayer(cfg, dtype))
        self.layer_norm = LayerNorm(cfg.encoder.embed_dim, dtype) if cfg.encoder.normalize_before else None

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor,
                bias_spec: Optional[BiasSpec] = None) -> torch.Tensor:
        """x (B, T, E) adapted embeddings; padding_mask (B, T) True = valid."""
        attn_mask = padding_mask[:, None, None, :]
        for i in range(self.n_layers):
            bias = bias_spec.layer_bias(i) if bias_spec is not None else None
            x = getattr(self, f"layers_{i}")(x, attn_mask, bias)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x


class TransformerDecoder(nn.Module):
    """Decoder stack; full-sequence and incremental (KV cache) modes."""

    def __init__(self, cfg: GeneralistModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.n_layers = cfg.decoder.layers
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", TransformerDecoderLayer(cfg, dtype))
        self.layer_norm = LayerNorm(cfg.decoder.embed_dim, dtype) if cfg.decoder.normalize_before else None

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
    ):
        Tt = x.shape[1]
        self_mask = None
        if cache is None and self_padding_mask is not None:
            self_mask = self_padding_mask[:, None, None, :]
        cross_mask = None
        if encoder_padding_mask is not None:
            cross_mask = encoder_padding_mask[:, None, None, :]

        new_cache: Optional[Dict[str, Any]] = {} if cache is not None else None
        for i in range(self.n_layers):
            self_bias = None
            if self_bias_spec is not None:
                self_bias = (self_bias_spec.layer_bias(i) if cache is None
                             else self_bias_spec.layer_bias_rows(i, cache_index, Tt))
            cb = cross_bias
            if cb is not None and cache is not None:
                start = max(0, min(cache_index, cb.shape[2] - Tt))
                cb = cb[:, :, start:start + Tt]
            x, layer_cache = getattr(self, f"layers_{i}")(
                x, encoder_out, self_mask, self_bias, cross_mask, cb,
                None if cache is None else cache[f"layers_{i}"], full_context,
            )
            if cache is not None:
                new_cache[f"layers_{i}"] = layer_cache
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x, new_cache
