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

Which kernel of the source runs, and at which tile and K split, is
:func:`int8_plan`, a pure function of (M, N, K) and the operands' alignment
that the CPU tests check: the int8 tensor cores for K a multiple of 16 on
16-byte aligned operands (all M rows in one block up to ``SMALL_M``, 128 x
128 tiles above; K split over a thread-block cluster until ``MIN_BLOCKS``
blocks run), the ``__dp4a`` kernel otherwise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import torch

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

SMALL_M = 64        # rows that one block of the small-M plan holds (a decode step's batch x beam)
MIN_BLOCKS = 100    # K is split until at least this many blocks run
MAX_SPLIT = 8       # ranks of a portable thread-block cluster
MIN_SPLIT_K = 128   # bytes of K a rank takes at least (96-byte ranks measured slower)
_KERNEL_CODE = {"dp4a": 0, "small_m": 1, "large_m": 2}


@dataclass(frozen=True)
class Int8Plan:
    """How one B7 call runs: ``kernel`` is 'small_m' or 'large_m' (the
    int8 tensor cores) or 'dp4a' (the CUDA cores, for K % 16 != 0 or an
    operand off a 16-byte boundary); the output is cut into ``tile_m`` x
    ``tile_n`` tiles, and each tile's K into ``split`` ranks of one cluster."""

    kernel: str
    tile_m: int
    tile_n: int
    split: int = 1

    def blocks(self, M: int, N: int) -> int:
        return -(-M // self.tile_m) * -(-N // self.tile_n) * self.split


def int8_plan(M: int, N: int, K: int, aligned: bool = True) -> Int8Plan:
    """The plan of :func:`int8_matmul_fwd` for xq (M, K) and q (N, K);
    ``aligned``: both int8 operands start on a 16-byte boundary."""
    if K % 16 or not aligned:
        return Int8Plan("dp4a", 64, 64)
    if M <= SMALL_M:
        kernel, tile_m = "small_m", SMALL_M
        tile_n = 64 if -(-N // 64) >= MIN_BLOCKS else 32
    else:
        kernel, tile_m, tile_n = "large_m", 128, 128
    tiles = -(-M // tile_m) * -(-N // tile_n)
    split = 1
    while tiles * split < MIN_BLOCKS and split < MAX_SPLIT and K // (2 * split) >= MIN_SPLIT_K:
        split *= 2
    return Int8Plan(kernel, tile_m, tile_n, split)


def split_ranges(K: int, split: int) -> List[Tuple[int, int]]:
    """The K range [k0, k1) of each cluster rank, in whole 16-byte chunks,
    as the kernel cuts it."""
    chunks = K // 16
    return [(16 * (r * chunks // split), 16 * ((r + 1) * chunks // split)) for r in range(split)]


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def int8_matmul_fwd(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel B7: ``dequant(xq @ q.T)`` in one pass. xq (M, K) int8, sx
    (M, 1) fp32, q (N, K) int8, scale (N,) fp32 -> (M, N) in ``out_dtype``
    (bf16 or fp32).

    CUDA tensors launch the kernel that :func:`int8_plan` picks (counted in
    ``int8_matmul_fwd.launches``); CPU tensors run
    :func:`int8_matmul_reference`."""
    _check(xq, sx, q, scale, out_dtype)
    if not xq.is_cuda:
        return int8_matmul_reference(xq, sx, q, scale, out_dtype)
    fn = _bind()
    M, K = xq.shape
    N = q.shape[0]
    plan = int8_plan(M, N, K, xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    with torch.cuda.device(xq.device):
        out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
        err = fn(ctypes.c_void_p(xq.data_ptr()), ctypes.c_void_p(sx.data_ptr()),
                 ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(scale.data_ptr()),
                 ctypes.c_void_p(out.data_ptr()), M, N, K, _KERNEL_CODE[plan.kernel],
                 plan.tile_n, plan.split, _DTYPE_CODE[out_dtype],
                 ctypes.c_void_p(torch.cuda.current_stream(xq.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"int8_matmul_fwd: CUDA launch failed with error {err}")
    int8_matmul_fwd.launches += 1
    return out


int8_matmul_fwd.launches = 0
