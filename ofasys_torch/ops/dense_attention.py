"""Dense (whole-row) attention for short sequences: kernel B1 (counterpart
of ofasys_tpu/ops/pallas_dense_attention.py, forward only).

``dense_attention_fwd`` launches the CUDA kernel of
``ofasys_torch/csrc/dense_attention_fwd.cu`` for CUDA tensors, and runs its
plain version, :func:`dense_attention_fwd_reference`, for CPU tensors. There
is no other route: on a CUDA tensor it launches the kernel or raises.

Conventions match ops/attention.dot_product_attention at the public entry
``dense_attention``: q (B, Tq, H, D), k/v (B, Tk, H, D), bias additive and
batch-shared (1, H, Tq, Tk), mask bool/int8 (B, 1, 1, Tk) keep-mask.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ofasys_torch.ops.attention import MASK_VALUE

# the kernel takes whole rows of at most this many keys; longer sequences
# belong to the flash kernel (B3)
MAX_T = 256

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def dense_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``_xla_reference`` (scale 1, causal folded into
    the bias), plus the lse. q (B, Tq, E), k/v (B, Tk, E), bias (H, Tq, Tk),
    mask (B, 1, Tk) -> out (B, Tq, E) in q's dtype, lse (B, H, Tq) fp32."""
    B, Tq, E = q.shape
    Tk = k.shape[1]
    H = num_heads
    D = E // H
    qh = q.reshape(B, Tq, H, D).permute(0, 2, 1, 3).float()
    kh = k.reshape(B, Tk, H, D).permute(0, 2, 3, 1).float()
    vh = v.reshape(B, Tk, H, D).permute(0, 2, 1, 3)
    s = torch.matmul(qh, kh)
    if bias is not None:
        s = s + bias[None].float()
    if mask is not None:
        s = torch.where(mask[:, None] != 0, s, torch.full((), MASK_VALUE, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(q.dtype), vh)
    lse = torch.logsumexp(s, dim=-1)
    return o.permute(0, 2, 1, 3).reshape(B, Tq, E), lse


def _check(q, k, v, bias, mask, num_heads):
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("dense_attention_fwd: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dense_attention_fwd: q/k/v must share bf16 or fp32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("dense_attention_fwd: q (B,Tq,E), k and v (B,Tk,E) expected")
    B, Tq, E = q.shape
    Tk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != E or E % num_heads:
        raise ValueError(f"dense_attention_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"heads {num_heads}")
    D = E // num_heads
    if not (0 < Tq <= MAX_T and 0 < Tk <= MAX_T and 0 < D <= 256 and B > 0):
        raise ValueError(f"dense_attention_fwd: needs 0 < Tq, Tk <= {MAX_T} and D <= 256, "
                         f"got Tq={Tq} Tk={Tk} D={D}")
    if bias is not None and (bias.dtype != torch.bfloat16
                             or tuple(bias.shape) != (num_heads, Tq, Tk)):
        raise ValueError("dense_attention_fwd: bias must be bf16 (H, Tq, Tk)")
    if mask is not None and (mask.dtype != torch.int8 or tuple(mask.shape) != (B, 1, Tk)):
        raise ValueError("dense_attention_fwd: mask must be int8 (B, 1, Tk)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dense_attention_fwd: inputs must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bind():
    from ofasys_torch.ops.cuda_build import load

    lib = load("dense_attention_fwd")
    fn = lib.dense_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dense_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: q (B, Tq, E) pre-scaled, k/v (B, Tk, E), bias bf16
    (H, Tq, Tk) or None, mask int8 (B, 1, Tk) or None -> out (B, Tq, E) in
    q's dtype and lse (B, H, Tq) fp32.

    CUDA tensors launch the kernel (counted in ``dense_attention_fwd.launches``);
    CPU tensors run :func:`dense_attention_fwd_reference`."""
    _check(q, k, v, bias, mask, num_heads)
    if not q.is_cuda:
        return dense_attention_fwd_reference(q, k, v, bias, mask, num_heads)
    fn = _bind()
    B, Tq, E = q.shape
    Tk = k.shape[1]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((B, num_heads, Tq), dtype=torch.float32, device=q.device)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(mask), _ptr(out), _ptr(lse),
                 B, num_heads, Tq, Tk, E // num_heads, _DTYPE_CODE[q.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dense_attention_fwd: CUDA launch failed with error {err}")
    dense_attention_fwd.launches += 1
    return out, lse


dense_attention_fwd.launches = 0


def dense_attention(
    q: torch.Tensor,                       # (B, Tq, H, D)
    k: torch.Tensor,                       # (B, Tk, H, D)
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,   # (1, H, Tq, Tk) additive, batch-shared
    mask: Optional[torch.Tensor] = None,   # bool/int8 (B|1, 1, 1, Tk) keep-mask
    scale: float = 1.0,
    causal: bool = False,
) -> torch.Tensor:
    """Short-sequence attention through kernel B1; the prep matches
    ofasys_tpu's ``dense_attention``: q is pre-scaled in fp32 and cast back,
    the causal mask is folded into the bias as -1e9, and the bias is
    broadcast to (H, Tq, Tk) and rounded to bf16."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    q = (q.float() * scale).to(q.dtype)
    if causal:
        i = torch.arange(Tq, device=q.device)[:, None]
        j = torch.arange(Tk, device=q.device)[None, :]
        cm = j <= i + (Tk - Tq)
        if bias is None:
            bias = torch.where(cm, 0.0, MASK_VALUE)[None, None]
        else:
            bias = torch.where(cm[None, None], bias, torch.full((), MASK_VALUE, device=q.device))
    bf = None
    if bias is not None:
        if bias.dim() == 4:
            if bias.shape[0] != 1:
                raise ValueError("dense_attention bias must be batch-shared (1,H,Tq,Tk)")
            bias = bias[0]
        bf = bias.expand(H, Tq, Tk).to(torch.bfloat16).contiguous()
    mf = None
    if mask is not None:
        mf = mask.to(torch.int8).expand(B, 1, 1, Tk).reshape(B, 1, Tk).contiguous()
    out, _ = dense_attention_fwd(
        q.reshape(B, Tq, H * D).contiguous(), k.reshape(B, Tk, H * D).contiguous(),
        v.reshape(B, Tk, H * D).contiguous(), bf, mf, H,
    )
    return out.reshape(B, Tq, H, D)


def dense_supported(B: int, Tq: int, Tk: int, D: int, H: int, dropout_rate: float) -> bool:
    """Gate: shapes where the whole-row kernel applies. Rows are capped at
    MAX_T keys (flash attention takes longer ones); tiny dispatches (B=1
    encoder at serving) stay on the plain path."""
    if dropout_rate > 0.0:
        return False
    if Tq > MAX_T or Tk > MAX_T or D > 256 or H * D > 4096:
        return False
    return B * Tq >= 256
