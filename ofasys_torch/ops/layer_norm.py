"""LayerNorm over the rows of an (N, E) matrix: kernels B6-fwd and B6-bwd,
the counterpart of ofasys_tpu/ops/pallas_layernorm.py.

``layer_norm_fwd`` launches the forward kernel and ``layer_norm_bwd`` the
backward kernel of ``ofasys_torch/csrc/layer_norm.cu`` for CUDA tensors;
for CPU tensors each runs its plain version. On a CUDA tensor each launches
its kernel or raises.

Numerics are those of the Pallas kernels: fp32 statistics in the
fast-variance form ``E[x^2] - mu^2`` (as flax.linen.LayerNorm computes them),
eps inside the square root, y rounded once to x's dtype; the backward takes
mu and rstd from the forward and returns dg and db as fp32 sums over all
rows. ofasys_tpu's gate ``ln_supported`` (E % 128, a TPU backend) does not
carry over: the kernels take any E. B6-fwd holds each row in registers at
the widths of the arch table and their FFN widths (``ln_fwd_plan``, a pure
function the CPU tests check) and walks the row twice at any other E.

  * :class:`FusedLayerNormFunction`: B6-fwd forward, B6-bwd backward
    (``fused_layer_norm``; ``ln_impl='pallas'``).
  * :class:`HybridLayerNormFunction`: the plain forward, which ofasys_tpu
    computes outside Pallas, and B6-bwd backward (``hybrid_layer_norm``;
    ``ln_impl='hybrid'``).
  * :class:`FusedLayerNorm`: the module, a subclass of the port's
    ``LayerNorm`` so that parameter export and init treat it as one.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from ofasys_torch.model.config import _ARCH_TABLE
from ofasys_torch.model.transformer import LayerNorm

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# the widths B6-fwd holds in registers: every embed and FFN width of the
# arch table (256 to 11,264)
LN_WIDTHS = frozenset(w for e, f, *_ in _ARCH_TABLE.values() for w in (e, f))
# the slot counts the kernel is instantiated for (layer_norm.cu `fwd_rows`)
LN_SLOTS = (1, 2, 3, 4, 5, 6, 8, 10, 11)
ROW_WARPS_MAX_E = 1024      # one warp a row up to this width, a group of 2-8 above
SLOTS_TARGET = 3            # 16-byte vectors a lane the group size aims at


@dataclass(frozen=True)
class LnFwdPlan:
    """How one B6-fwd call runs: ``kernel`` 'rows' holds each row in
    registers, ``warps`` warps a row and ``slots`` 16-byte vectors a lane;
    'two_walk' walks the row twice, in 16-byte vectors when ``vec``."""

    kernel: str
    warps: int = 0
    slots: int = 0
    vec: bool = False


def ln_fwd_plan(E: int, element_size: int, aligned: bool = True) -> LnFwdPlan:
    """The plan of :func:`layer_norm_fwd` for rows of E elements of
    ``element_size`` bytes (2 bf16, 4 fp32); ``aligned``: every row and g
    and b start on a 16-byte boundary."""
    per = 16 // element_size
    if E not in LN_WIDTHS or not aligned:
        return LnFwdPlan("two_walk", vec=aligned and E % per == 0)
    nv = E // per
    warps = 1 if E <= ROW_WARPS_MAX_E else min(8, -(-nv // (32 * SLOTS_TARGET)))
    return LnFwdPlan("rows", warps, -(-nv // (32 * warps)))


def layer_norm_fwd_reference(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                             eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``_ln_fwd_kernel``: x (N, E), g and b (E,) fp32
    -> y (N, E) in x's dtype, mu and rstd (N, 1) fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mu) * rstd * g + b).to(x.dtype)
    return y, mu, rstd


def layer_norm_bwd_reference(x: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                             rstd: torch.Tensor, dy: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of ``_ln_bwd_kernel``: x and dy (N, E), g (E,), mu
    and rstd (N, 1) -> dx (N, E) in x's dtype, dg and db (E,) fp32 summed
    over the rows."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mu) * rstd
    dg = (dyf * xhat).sum(0)
    db = dyf.sum(0)
    dxhat = dyf * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = ((dxhat - m1 - xhat * m2) * rstd).to(x.dtype)
    return dx, dg, db


def _check(what, x, g, *rows):
    """x a contiguous bf16 or fp32 (N, E), g a contiguous fp32 (E,), and each
    of ``rows`` a (tensor, shape, dtype) it must have; all on x's device."""
    if x.dtype not in _DTYPE_CODE or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous bf16 or fp32 (N, E) matrix, got "
                         f"{x.dtype} {tuple(x.shape)}")
    N, E = x.shape
    if N <= 0 or E <= 0:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    if g.dtype != torch.float32 or tuple(g.shape) != (E,) or not g.is_contiguous():
        raise ValueError(f"{what}: g and b must be contiguous fp32 ({E},)")
    for t, shape, dtype in rows:
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if any(t.device != x.device for t in (g,) + tuple(r[0] for r in rows)):
        raise ValueError(f"{what}: all tensors must be on one device")


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """1 when every row of every (N, E) operand starts on a 16-byte boundary
    and holds whole 16-byte vectors: the kernels then load 16 bytes at once."""
    per = 16 // x.element_size()
    return int(x.shape[1] % per == 0 and all(t.data_ptr() % 16 == 0 for t in (x,) + others))


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, g, b, y, mu, rstd; N, E; eps; warps, slots, vec, dtype; stream
    "layer_norm_fwd": [_P] * 6 + [_I] * 2 + [ctypes.c_float] + [_I] * 4 + [_P],
    # x, g, mu, rstd, dy, dx, dg, db, part; N, E, chunks, rows, vec, dtype; stream
    "layer_norm_bwd": [_P] * 9 + [_I] * 6 + [_P],
}


def _bind(name):
    from ofasys_torch.ops.cuda_build import load

    fn = getattr(load("layer_norm"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_fwd(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6-fwd: x (N, E) bf16 or fp32, g and b (E,) fp32 -> y (N, E)
    in x's dtype, mu and rstd (N, 1) fp32.

    CUDA tensors launch the kernel that :func:`ln_fwd_plan` picks (counted
    in ``layer_norm_fwd.launches``); CPU tensors run
    :func:`layer_norm_fwd_reference`."""
    _check("layer_norm_fwd", x, g, (b, tuple(g.shape), torch.float32))
    if not x.is_cuda:
        return layer_norm_fwd_reference(x, g, b, eps)
    fn = _bind("layer_norm_fwd")
    N, E = x.shape
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        mu = torch.empty((N, 1), dtype=torch.float32, device=x.device)
        rstd = torch.empty((N, 1), dtype=torch.float32, device=x.device)
        plan = ln_fwd_plan(E, x.element_size(), all(t.data_ptr() % 16 == 0 for t in (x, y, g, b)))
        err = fn(_ptr(x), _ptr(g), _ptr(b), _ptr(y), _ptr(mu), _ptr(rstd), N, E, float(eps),
                 plan.warps, plan.slots, int(plan.vec), _DTYPE_CODE[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd: CUDA launch failed with error {err}")
    layer_norm_fwd.launches += 1
    return y, mu, rstd


layer_norm_fwd.launches = 0


def _chunks(N: int, device: torch.device) -> Tuple[int, int]:
    """(chunks, rows per chunk) of the backward's first pass: about two
    blocks per SM, each summing one fixed chunk of consecutive rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = max(1, -(-N // (2 * sms)))
    return -(-N // rows), rows


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
                   dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6-bwd: the gradients of B6-fwd for the cotangent ``dy`` (N, E)
    in x's dtype, given x, g and the forward's mu and rstd (N, 1) -> dx in
    x's dtype, dg and db (E,) fp32.

    CUDA tensors launch the kernel (counted in ``layer_norm_bwd.launches``,
    one per call: the call runs the per-chunk pass and the reduction of its
    partials); CPU tensors run :func:`layer_norm_bwd_reference`."""
    stats = tuple(x.shape[:1]) + (1,)
    _check("layer_norm_bwd", x, g, (mu, stats, torch.float32), (rstd, stats, torch.float32),
           (dy, tuple(x.shape), x.dtype))
    if not x.is_cuda:
        return layer_norm_bwd_reference(x, g, mu, rstd, dy)
    fn = _bind("layer_norm_bwd")
    N, E = x.shape
    with torch.cuda.device(x.device):
        chunks, rows = _chunks(N, x.device)
        dx = torch.empty_like(x)
        dg = torch.empty((E,), dtype=torch.float32, device=x.device)
        db = torch.empty((E,), dtype=torch.float32, device=x.device)
        part = torch.empty((chunks, 2, E), dtype=torch.float32, device=x.device)
        err = fn(_ptr(x), _ptr(g), _ptr(mu), _ptr(rstd), _ptr(dy), _ptr(dx), _ptr(dg), _ptr(db),
                 _ptr(part), N, E, chunks, rows, _vec(x, dy, dx), _DTYPE_CODE[x.dtype],
                 _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd: CUDA launch failed with error {err}")
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0


class FusedLayerNormFunction(torch.autograd.Function):
    """B6-fwd forward, B6-bwd backward (``fused_layer_norm``'s custom vjp):
    x (N, E), g and b (E,) fp32 -> y (N, E) in x's dtype."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mu, rstd = layer_norm_fwd(x, g, b, eps)
        ctx.save_for_backward(x, g, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mu, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, g, mu, rstd, dy.to(x.dtype).contiguous())
        return dx, dg, db, None


class HybridLayerNormFunction(torch.autograd.Function):
    """The plain fast-variance forward (any device; ofasys_tpu leaves it to
    XLA), B6-bwd backward (``hybrid_layer_norm``'s custom vjp)."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        y, mu, rstd = layer_norm_fwd_reference(x, g, b, eps)
        ctx.save_for_backward(x, g, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mu, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, g, mu, rstd, dy.to(x.dtype).contiguous())
        return dx, dg, db, None


class FusedLayerNorm(LayerNorm):
    """The port's LayerNorm (same parameters, names and init) computed by
    B6: ``mode='fused'`` runs B6-fwd and B6-bwd (``ln_impl='pallas'``),
    ``mode='hybrid'`` the plain forward and B6-bwd (``ln_impl='hybrid'``).
    The output is cast to the module dtype, as ofasys_tpu's FusedLayerNorm
    casts to its ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, mode: str = "fused"):
        if mode not in ("fused", "hybrid"):
            raise ValueError(f"unknown FusedLayerNorm mode {mode!r}; expected 'fused' or 'hybrid'")
        super().__init__(dim, dtype)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = HybridLayerNormFunction if self.mode == "hybrid" else FusedLayerNormFunction
        shape = x.shape
        y = fn.apply(x.reshape(-1, shape[-1]).contiguous(), self.weight, self.bias, self.eps)
        return y.reshape(shape).to(self.dtype)
