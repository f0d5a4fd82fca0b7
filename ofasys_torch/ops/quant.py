"""Int8 serving (counterpart of ofasys_tpu/ops/quant.py).

Symmetric post-training quantization, no zero point:

  * weights are quantized once, per output channel: ``w ~= q * scale``
    with ``q`` int8 and ``scale`` fp32 over the output axis.
  * activations are quantized per row at matmul time ('w8a8'), so the
    contraction runs on int8 (kernel B7, ops/int8_matmul.py); 'w8' instead
    dequantizes the weight to the compute dtype and runs a plain matmul.

:func:`quantize_for_serving` turns a net in place into its serving form:
every ``Dense`` whose weight matches the pattern drops its fp32 weight
(halving the bytes is the point) and gains the buffers ``q`` (out, in) int8
and ``scale`` (out,) fp32; biases stay fp32. The token embedding keeps its
fp32 table for exact input lookups and gains an int8 copy with per-vocab-row
scales that only the tied output projection (``Embed.attend``) reads.
Buffers move with ``net.to(device)`` and are never cast. ``Dense.forward``
and ``Embed.attend`` (model/transformer.py) take the int8 route when the
buffers are there.

Not ported yet: quantized training (``int8_train_matmul``, ``qtrain``;
ROADMAP Queue A) and scan-stacked (L, in, out) kernels (``scan_layers`` is
not ported).
"""

from __future__ import annotations

import re
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.ops.int8_matmul import int8_matmul_fwd

_EPS = 1e-8

# weights of these module names are int8-quantized by default: the q/k/v/out
# projections and FFN matmuls of both stacks (and per-modality FFN experts),
# matched against the port's dotted parameter names
DEFAULT_PATTERN = r"(^|\.)(q_proj|k_proj|v_proj|out_proj|fc1|fc2|experts_fc[12]_\d+)\.weight$"


def quantize_weight(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per slice along ``axis``,
    the contraction axis that is reduced: for a (out, in) weight the default
    gives one scale per output row. ``round`` is half to even, as
    ``jnp.round``. Returns (q int8 of w's shape, scale fp32)."""
    wf = w.detach().float()
    scale = torch.clamp(wf.abs().amax(dim=axis), min=_EPS) / 127.0
    q = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization over the last axis:
    (xq int8, sx (..., 1) fp32). Divides by sx, as ofasys_tpu does, so the
    bits match (a multiply by 1/sx would not)."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=_EPS) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, mode: str = "w8a8",
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ dequant(q).T`` for x (..., in), q (out, in) int8, scale (out,):
    'w8a8' quantizes the rows of x and runs kernel B7; 'w8' dequantizes q to
    ``out_dtype`` and runs a plain matmul. Returns (..., out) in ``out_dtype``."""
    if mode == "w8":
        w = q.to(out_dtype) * scale.to(out_dtype)[:, None]
        return F.linear(x.to(out_dtype), w)
    if mode != "w8a8":
        raise ValueError(f"unknown quant mode {mode!r}; expected 'w8a8' or 'w8'")
    lead = x.shape[:-1]
    xq, sx = _quantize_rows(x.reshape(-1, x.shape[-1]))
    out = int8_matmul_fwd(xq, sx, q, scale, out_dtype)
    return out.reshape(*lead, q.shape[0])


def is_quantized(module: nn.Module) -> bool:
    """Whether ``module`` holds an int8 serving copy (buffers ``q`` and
    ``scale``)."""
    return isinstance(getattr(module, "q", None), torch.Tensor)


def quantize_module(module: nn.Module, q: torch.Tensor, scale: torch.Tensor):
    """Give ``module`` its int8 buffers; a Dense (``nn.Linear``) drops its
    fp32 weight, an embedding keeps it for input lookups."""
    if isinstance(module, nn.Linear) and "weight" in module._parameters:
        del module.weight
    module.register_buffer("q", q.contiguous())
    module.register_buffer("scale", scale.contiguous())


def quantize_for_serving(net: nn.Module, *, pattern: str = DEFAULT_PATTERN,
                         quantize_logits: bool = True,
                         embed_name: str = "embed_tokens") -> nn.Module:
    """Turn ``net`` in place into its int8 serving form (module docstring)
    and return it. Matched Dense weights become int8 ``q`` (out, in) with
    per-output ``scale``; with ``quantize_logits`` the embedding
    ``embed_name`` also gains an int8 attend table (V, E) with per-vocab-row
    scales. Raises when the pattern matches no Dense weight."""
    rx = re.compile(pattern)
    n = 0
    with torch.no_grad():
        for name, module in list(net.named_modules()):
            if not isinstance(module, nn.Linear) or is_quantized(module):
                continue
            if rx.search(f"{name}.weight" if name else "weight") is None:
                continue
            quantize_module(module, *quantize_weight(module.weight, axis=-1))
            n += 1
        if n == 0:
            raise ValueError(f"quantize_for_serving: pattern {pattern!r} matched no Dense "
                             "weight; is this a GeneralistNet?")
        emb = getattr(net, embed_name, None)
        if quantize_logits and isinstance(emb, nn.Embedding) and not is_quantized(emb):
            quantize_module(emb, *quantize_weight(emb.weight, axis=-1))
    return net
