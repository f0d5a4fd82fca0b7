"""Dense (whole-row) attention for short sequences: kernels B1 (forward),
B2 (backward) and B2r (row-major backward), the counterpart of
ofasys_tpu/ops/pallas_dense_attention.py.

``dense_attention_fwd`` launches the CUDA kernel of
``ofasys_torch/csrc/dense_attention_fwd.cu``, ``dense_attention_bwd`` the one
of ``ofasys_torch/csrc/dense_attention_bwd.cu`` and
``dense_attention_bwd_rowmajor`` the one of
``ofasys_torch/csrc/dense_attention_bwd_rowmajor.cu`` for CUDA tensors; for
CPU tensors each runs its plain version (:func:`dense_attention_fwd_reference`,
:func:`dense_attention_bwd_reference`,
:func:`dense_attention_bwd_rowmajor_reference`). There is no other route: on
a CUDA tensor each launches its kernel or raises.
:class:`DenseAttentionFunction` joins them as one autograd function, as
``_dense_attention``'s custom vjp does in JAX: the backward is B2, or B2r
for a causal call and whenever ``OFASYS_DENSE_BWD=rowmajor`` is set.

Conventions match ops/attention.dot_product_attention at the public entry
``dense_attention``: q (B, Tq, H, D), k/v (B, Tk, H, D), bias additive and
batch-shared (1, H, Tq, Tk), mask bool/int8 (B, 1, 1, Tk) keep-mask.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ofasys_torch.ops.attention import MASK_VALUE

# the kernel takes whole rows of at most this many keys; longer sequences
# belong to the flash kernel (B3)
MAX_T = 256

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _scores(qh, kh, bias, mask, scale, causal):
    """fp32 (B, H, Tq, Tk) logits of the kernels (``_scores`` in the JAX
    file): ``q.k * scale + bias``, -1e9 on masked keys and, under ``causal``,
    on keys ``j > i + (Tk - Tq)``. qh (B, H, Tq, D) and kh (B, H, Tk, D) fp32."""
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias[None].float()
    neg = torch.full((), MASK_VALUE, device=s.device)
    if mask is not None:
        s = torch.where(mask[:, None] != 0, s, neg)
    if causal:
        Tq, Tk = s.shape[-2:]
        i = torch.arange(Tq, device=s.device)[:, None]
        j = torch.arange(Tk, device=s.device)[None, :]
        s = torch.where(j <= i + (Tk - Tq), s, neg)
    return s


def dense_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    scale: float = 1.0, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``_xla_reference``, plus the lse. q (B, Tq, E),
    k/v (B, Tk, E), bias (H, Tq, Tk), mask (B, 1, Tk) -> out (B, Tq, E) in
    q's dtype, lse (B, H, Tq) fp32."""
    B, Tq, E = q.shape
    Tk = k.shape[1]
    H = num_heads
    D = E // H
    qh = q.reshape(B, Tq, H, D).permute(0, 2, 1, 3).float()
    kh = k.reshape(B, Tk, H, D).permute(0, 2, 1, 3).float()
    vh = v.reshape(B, Tk, H, D).permute(0, 2, 1, 3)
    s = _scores(qh, kh, bias, mask, scale, causal)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(q.dtype), vh)
    lse = torch.logsumexp(s, dim=-1)
    return o.permute(0, 2, 1, 3).reshape(B, Tq, E), lse


def _check(q, k, v, bias, mask, num_heads, causal=False):
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
    if causal and Tq > Tk:
        raise ValueError(f"dense_attention: causal needs Tq <= Tk (a row with no visible key), "
                         f"got Tq={Tq} Tk={Tk}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bind():
    from ofasys_torch.ops.cuda_build import load

    lib = load("dense_attention_fwd")
    fn = lib.dense_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dense_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    scale: float = 1.0, causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1: q (B, Tq, E), k/v (B, Tk, E), bias bf16 (H, Tq, Tk) or
    None, mask int8 (B, 1, Tk) or None -> out (B, Tq, E) in q's dtype and
    lse (B, H, Tq) fp32. ``scale`` multiplies q.k and ``causal`` hides keys
    ``j > i + (Tk - Tq)`` inside the kernel (the model's path pre-scales q
    and folds the causal mask into the bias: scale 1, causal False).

    CUDA tensors launch the kernel (counted in ``dense_attention_fwd.launches``);
    CPU tensors run :func:`dense_attention_fwd_reference`."""
    _check(q, k, v, bias, mask, num_heads, causal)
    if not q.is_cuda:
        return dense_attention_fwd_reference(q, k, v, bias, mask, num_heads, scale, causal)
    fn = _bind()
    B, Tq, E = q.shape
    Tk = k.shape[1]
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((B, num_heads, Tq), dtype=torch.float32, device=q.device)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(mask), _ptr(out), _ptr(lse),
                 B, num_heads, Tq, Tk, E // num_heads, float(scale), int(causal),
                 _DTYPE_CODE[q.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dense_attention_fwd: CUDA launch failed with error {err}")
    dense_attention_fwd.launches += 1
    return out, lse


dense_attention_fwd.launches = 0


def dense_attention_bwd_rowmajor_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    scale: float, causal: bool, want_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch twin of the Pallas row-major backward (``_bwd_kernel``),
    written out in its arithmetic (not autograd of the forward): scores
    recomputed in fp32 with ``scale`` and the causal mask inside,
    ``p = exp(s - lse)``, ``dv = round(p)^T do``, ``dp = do v^T``,
    ``dd = rowsum(dp * p)``, ``ds = p (dp - dd)`` in fp32, ``dbias`` the fp32
    batch sum of ``ds`` (before the scale), ``dq = round(ds * scale) k`` and
    ``dk = round(ds * scale)^T q`` with q as given, round() to q's dtype.
    q/do (B, Tq, E), k/v (B, Tk, E), lse (B, H, Tq), bias (H, Tq, Tk), mask
    (B, 1, Tk) -> dq, dk, dv in q's dtype and dbias (H, Tq, Tk) fp32, or None
    without a bias or when ``want_dbias`` is False."""
    B, Tq, E = q.shape
    Tk = k.shape[1]
    H = num_heads
    D = E // H
    dt = q.dtype

    def heads(t, T):
        return t.reshape(B, T, H, D).permute(0, 2, 1, 3).float()    # (B, H, T, D)

    qh, kh, vh, doh = heads(q, Tq), heads(k, Tk), heads(v, Tk), heads(do, Tq)
    s = _scores(qh, kh, bias, mask, scale, causal)
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    dd = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - dd)
    dbias = ds.sum(0) if bias is not None and want_dbias else None
    dsb = (ds * scale if scale != 1.0 else ds).to(dt).float()
    dq = torch.matmul(dsb, kh)
    dk = torch.matmul(dsb.transpose(-1, -2), qh)

    def back(t, T):
        return t.permute(0, 2, 1, 3).reshape(B, T, E).to(dt)

    return back(dq, Tq), back(dk, Tk), back(dv, Tk), dbias


def dense_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    want_dbias: bool = True, scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch twin of the Pallas backward ``_bwd_kernel_t``: the same
    arithmetic as :func:`dense_attention_bwd_rowmajor_reference` without the
    causal mask (the TPU kernels differ in orientation, not in what they
    compute)."""
    return dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, num_heads,
                                                  scale, False, want_dbias)


def _bind_bwd():
    from ofasys_torch.ops.cuda_build import load

    lib = load("dense_attention_bwd")
    fn, key_range = lib.dense_attention_bwd, lib.dense_attention_bwd_key_range
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        key_range.argtypes = [ctypes.c_int, ctypes.c_int]
        key_range.restype = ctypes.c_int
    return fn, key_range


def _batch_chunks(B: int, Tq: int, H: int, device: torch.device) -> int:
    """How many chunks of the batch pass 1 of B2's fp32 kernel splits into:
    enough blocks for about four per SM, each chunk's dbias partial summed
    after."""
    tiles = -(-Tq // 16) * H
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(B, -(-4 * sms // tiles)))


def _check_bwd(q, k, v, do, lse, bias, mask, num_heads, causal=False):
    _check(q, k, v, bias, mask, num_heads, causal)
    B, Tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError("dense_attention_bwd: do must be contiguous, shaped and typed as q")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, num_heads, Tq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("dense_attention_bwd: lse must be contiguous fp32 (B, H, Tq)")


def dense_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    want_dbias: bool = True, scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Kernel B2: the gradients of kernel B1 (without causal) for the output
    cotangent ``do`` (B, Tq, E) in q's dtype, given B1's inputs and its lse
    -> dq, dk, dv in q's dtype and the batch-summed dbias (H, Tq, Tk) fp32
    (None without a bias or when ``want_dbias`` is False).

    CUDA tensors launch the kernel (counted in ``dense_attention_bwd.launches``,
    one per call): bf16 the one-pass tensor-core kernel and, where they were
    split, the reductions of the dq range partials and of the dbias chunk
    partials; fp32 the two CUDA-core passes and the dbias reduction. CPU
    tensors run :func:`dense_attention_bwd_reference`."""
    _check_bwd(q, k, v, do, lse, bias, mask, num_heads)
    B, Tq, E = q.shape
    Tk = k.shape[1]
    H = num_heads
    if not q.is_cuda:
        return dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H, want_dbias, scale)
    fn, key_range = _bind_bwd()
    want_dbias = want_dbias and bias is not None
    D = E // H
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dd = dq_part = None
        if q.dtype == torch.bfloat16:
            # one block of the tensor-core kernel per (key range, head, chunk
            # of samples): enough chunks for one block on each SM
            ranges = -(-Tk // key_range(Tk, D))
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            chunks = max(1, min(B, -(-sms // (H * ranges))))
            if ranges > 1:      # the ranges' dq partials, then their parts of dd
                dq_part = torch.empty(ranges * B * Tq * (E + H), dtype=torch.float32,
                                      device=q.device)
        else:
            dd = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
            chunks = _batch_chunks(B, Tq, H, q.device)
        dbias = part = None
        if want_dbias:
            dbias = torch.empty((H, Tq, Tk), dtype=torch.float32, device=q.device)
            if chunks > 1:
                part = torch.empty((chunks, H, Tq, Tk), dtype=torch.float32, device=q.device)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(bias), _ptr(mask),
                 _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias), _ptr(dd), _ptr(part), _ptr(dq_part),
                 B, H, Tq, Tk, D, chunks, float(scale), _DTYPE_CODE[q.dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dense_attention_bwd: CUDA launch failed with error {err}")
    dense_attention_bwd.launches += 1
    return dq, dk, dv, dbias


dense_attention_bwd.launches = 0

# dynamic shared memory a block may opt in to on the H100 (227 KB)
_MAX_BLOCK_SMEM = 232448


def _bind_bwd_rowmajor():
    from ofasys_torch.ops.cuda_build import load

    lib = load("dense_attention_bwd_rowmajor")
    fn = lib.dense_attention_bwd_rowmajor
    key_range, smem = lib.dense_attention_bwd_rowmajor_key_range, lib.dense_attention_bwd_rowmajor_smem
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        key_range.argtypes = [ctypes.c_int] * 3
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        key_range.restype = ctypes.c_int
        smem.restype = ctypes.c_longlong
    return fn, key_range, smem


def dense_attention_bwd_rowmajor(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    bias: Optional[torch.Tensor], mask: Optional[torch.Tensor], num_heads: int,
    scale: float, causal: bool, want_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Kernel B2r: the gradients of kernel B1 called with the same ``scale``
    and ``causal``, in one pass per (sample, head): dq, dk, dv in q's dtype
    and the batch-summed dbias (H, Tq, Tk) fp32 (None without a bias or when
    ``want_dbias`` is False).

    CUDA tensors launch the kernel (counted in
    ``dense_attention_bwd_rowmajor.launches``, one per call): bf16 B2's
    tensor-core kernel with the causal mask inside where ``causal`` asks for
    it, fp32 the CUDA-core kernel; the call runs the kernel and, where they
    were split, the reductions of the dq partials of the key ranges and of
    the dbias partials of the batch chunks. CPU tensors run
    :func:`dense_attention_bwd_rowmajor_reference`."""
    _check_bwd(q, k, v, do, lse, bias, mask, num_heads, causal)
    B, Tq, E = q.shape
    Tk = k.shape[1]
    H = num_heads
    if not q.is_cuda:
        return dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, H, scale,
                                                      causal, want_dbias)
    fn, key_range, smem = _bind_bwd_rowmajor()
    D = E // H
    dtype = _DTYPE_CODE[q.dtype]
    kr = key_range(Tk, D, dtype)
    ranges = -(-Tk // kr)
    want_dbias = want_dbias and bias is not None
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # one block per (range of keys, head, chunk of samples): bf16 as B2,
        # enough chunks for one block on each SM; fp32 enough to fill the SMs
        # with as many blocks as their shared memory holds (at most 4)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        if q.dtype == torch.bfloat16:
            chunks = max(1, min(B, -(-sms // (H * ranges))))
        else:
            per_sm = min(4, _MAX_BLOCK_SMEM // smem(kr, D))
            chunks = max(1, min(B, per_sm * sms // (H * ranges)))
        dbias = part = dq_part = None
        if want_dbias:
            dbias = torch.empty((H, Tq, Tk), dtype=torch.float32, device=q.device)
            if chunks > 1:
                part = torch.empty((chunks, H, Tq, Tk), dtype=torch.float32, device=q.device)
        if ranges > 1:          # the ranges' dq partials, then their parts of dd
            dq_part = torch.empty(ranges * B * Tq * (E + H), dtype=torch.float32, device=q.device)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(bias), _ptr(mask),
                 _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias), _ptr(part), _ptr(dq_part),
                 B, H, Tq, Tk, D, chunks, float(scale), int(causal), dtype,
                 ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"dense_attention_bwd_rowmajor: CUDA launch failed with error {err}")
    dense_attention_bwd_rowmajor.launches += 1
    return dq, dk, dv, dbias


dense_attention_bwd_rowmajor.launches = 0


class DenseAttentionFunction(torch.autograd.Function):
    """Kernel B1 forward, kernel B2 or B2r backward (the custom vjp of
    ``_dense_attention``): q (B, Tq, E), k/v (B, Tk, E), bias bf16
    (H, Tq, Tk) or None, mask int8 (B, 1, Tk) or None -> out (B, Tq, E). The
    backward chooses as ``_vjp_bwd`` does: B2r for a causal call and when
    ``OFASYS_DENSE_BWD=rowmajor`` (read at backward time), else B2. The bias
    gradient comes back in the bias's dtype, as ``_vjp_bwd`` returns
    ``dbias.astype(bias.dtype)``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads, scale=1.0, causal=False):
        out, lse = dense_attention_fwd(q, k, v, bias, mask, num_heads, scale, causal)
        ctx.save_for_backward(q, k, v, bias, mask, lse)
        ctx.args = num_heads, scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, lse = ctx.saved_tensors
        num_heads, scale, causal = ctx.args
        want_dbias = ctx.needs_input_grad[3]
        if causal or os.environ.get("OFASYS_DENSE_BWD") == "rowmajor":
            dq, dk, dv, dbias = dense_attention_bwd_rowmajor(
                q, k, v, do.contiguous(), lse, bias, mask, num_heads, scale, causal, want_dbias)
        else:
            dq, dk, dv, dbias = dense_attention_bwd(
                q, k, v, do.contiguous(), lse, bias, mask, num_heads, want_dbias, scale)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None


def _dense_attention(q, k, v, bias, mask, scale: float, causal: bool, num_heads: int):
    """The counterpart of the JAX custom-vjp entry ``_dense_attention``: q
    (B, Tq, E), k/v (B, Tk, E), bias bf16 (H, Tq, Tk) or None, mask int8
    (B, 1, Tk) or None, with ``scale`` and ``causal`` applied inside the
    kernels -> out (B, Tq, E)."""
    return DenseAttentionFunction.apply(q, k, v, bias, mask, num_heads, scale, causal)


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
    """Short-sequence attention through kernels B1 and B2; the prep matches
    ofasys_tpu's ``dense_attention`` and stays visible to autograd: q is
    pre-scaled in fp32 and cast back (so dq picks up the scale outside the
    kernel), the causal mask is folded into the bias as -1e9, and the bias
    is broadcast to (H, Tq, Tk) and rounded to bf16 (so dbias reaches an
    fp32 bias through that cast)."""
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
    out = _dense_attention(
        q.reshape(B, Tq, H * D).contiguous(), k.reshape(B, Tk, H * D).contiguous(),
        v.reshape(B, Tk, H * D).contiguous(), bf, mf, 1.0, False, H,
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
