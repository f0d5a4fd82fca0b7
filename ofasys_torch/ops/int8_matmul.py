"""The W8A8 matrix product with its dequantizing epilogue: kernel B7, the
counterpart of ofasys_tpu/ops/pallas_int8.py.

``int8_matmul_fwd`` launches the CUDA kernel of
``ofasys_torch/csrc/int8_matmul.cu`` for CUDA tensors and runs its plain
version (:func:`int8_matmul_reference`) for CPU tensors; on a CUDA tensor
it launches the kernel or raises.

The weight is stored (N, K), K contiguous, like ``nn.Linear``'s (out, in), so
both operands of the contraction are K-contiguous. ofasys_tpu keeps the
logits table pre-transposed (E, V) against a TPU relayout cost; that does not
carry over. The TPU gate ``fused_supported`` (M >= 128, K and N multiples of
128, for MXU tiles) does not either: the kernel takes ragged M, N and K, so on
CUDA it serves every w8a8 contraction, the decode steps' M = batch * beam
rows included.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def int8_matmul_reference(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch twin of ``_kernel``: the exact integer product, then
    ``(acc * sx) * scale`` in fp32, in that order, rounded to ``out_dtype``.
    The product is taken in fp64, which holds every partial sum of int8
    products exactly (|acc| < 2^53) and runs on both devices; CUDA has no
    int8 ``torch.matmul``. xq (M, K) int8, sx (M, 1) fp32, q (N, K) int8,
    scale (N,) fp32 -> (M, N)."""
    acc = torch.matmul(xq.double(), q.double().t())
    return ((acc.float() * sx) * scale).to(out_dtype)


def _check(xq, sx, q, scale, out_dtype):
    tensors = (xq, sx, q, scale)
    if any(t.device != xq.device for t in tensors):
        raise ValueError("int8_matmul_fwd: all tensors must be on one device")
    if xq.dtype != torch.int8 or q.dtype != torch.int8:
        raise TypeError(f"int8_matmul_fwd: xq and q must be int8, got {xq.dtype}/{q.dtype}")
    if sx.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul_fwd: sx and scale must be fp32")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_matmul_fwd: out_dtype must be bf16 or fp32, got {out_dtype}")
    if xq.dim() != 2 or q.dim() != 2 or xq.shape[1] != q.shape[1]:
        raise ValueError(f"int8_matmul_fwd: xq (M, K) and q (N, K) expected, got "
                         f"{tuple(xq.shape)} and {tuple(q.shape)}")
    M, N = xq.shape[0], q.shape[0]
    if tuple(sx.shape) != (M, 1) or tuple(scale.shape) != (N,):
        raise ValueError(f"int8_matmul_fwd: sx must be ({M}, 1) and scale ({N},)")
    if min(M, N, xq.shape[1]) <= 0:
        raise ValueError("int8_matmul_fwd: empty operand")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_matmul_fwd: inputs must be contiguous")


def _bind():
    from ofasys_torch.ops.cuda_build import load

    fn = load("int8_matmul").int8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_fwd(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel B7: ``dequant(xq @ q.T)`` in one pass. xq (M, K) int8, sx
    (M, 1) fp32, q (N, K) int8, scale (N,) fp32 -> (M, N) in ``out_dtype``
    (bf16 or fp32).

    CUDA tensors launch the kernel (counted in ``int8_matmul_fwd.launches``);
    CPU tensors run :func:`int8_matmul_reference`."""
    _check(xq, sx, q, scale, out_dtype)
    if not xq.is_cuda:
        return int8_matmul_reference(xq, sx, q, scale, out_dtype)
    fn = _bind()
    M, K = xq.shape
    N = q.shape[0]
    vec = int(K % 16 == 0 and xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    with torch.cuda.device(xq.device):
        out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
        err = fn(ctypes.c_void_p(xq.data_ptr()), ctypes.c_void_p(sx.data_ptr()),
                 ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), M, N, K, vec, _DTYPE_CODE[out_dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(xq.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"int8_matmul_fwd: CUDA launch failed with error {err}")
    int8_matmul_fwd.launches += 1
    return out


int8_matmul_fwd.launches = 0
