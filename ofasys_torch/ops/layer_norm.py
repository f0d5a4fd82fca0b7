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
carry over: the kernels take any E. B6-fwd and B6-bwd hold each row in
registers at the widths of the arch table and their FFN widths
(``ln_fwd_plan``, ``ln_bwd_plan`` and B6-bwd's persistent partition
``ln_bwd_partition``: pure functions the CPU tests check) and walk the row
twice at any other E.

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


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, g, b, y, mu, rstd; N, E; eps; warps, slots, vec, dtype; stream
    "layer_norm_fwd": [_P] * 6 + [_I] * 2 + [ctypes.c_float] + [_I] * 4 + [_P],
    # x, g, mu, rstd, dy, dx, dg, db, part; N, E, chunks, rows, warps, slots, smem_acc,
    # ring, vec, dtype, parts; stream
    "layer_norm_bwd": [_P] * 9 + [_I] * 11 + [_P],
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


@dataclass(frozen=True)
class LnBwdPlan:
    """How one B6-bwd call runs: ``kernel`` 'rows' holds each row in
    registers, ``warps`` warps a row and ``slots`` 16-byte vectors a lane,
    the lane's dg and db in registers (``acc`` 'regs') or in its own words
    of shared memory ('smem'), ``ring`` row buffers a group that x and dy
    are copied into ahead of use (RING, or 0: loaded straight into
    registers), and at most ``sm_blocks`` blocks launched a SM
    (:func:`ln_bwd_partition` takes fewer at small N); 'two_walk' walks the
    row twice, in 16-byte vectors when ``vec``, about two blocks a SM."""

    kernel: str
    warps: int = 0
    slots: int = 0
    acc: str = ""
    ring: int = 0
    sm_blocks: int = 2
    vec: bool = False

    @property
    def groups(self) -> int:
        """Rows a block works on at once (a group of ``warps`` warps each;
        the two-walk kernel: eight warps of one row each)."""
        return 8 // self.warps if self.kernel == "rows" else 8


# the slot counts the backward is instantiated for, per element size and
# accumulator (layer_norm.cu `bwd_rows_bf16`, `bwd_rows_fp32`)
LN_BWD_SLOTS = {(2, "regs"): (1, 2, 3), (2, "smem"): (5, 6),
                (4, "regs"): (2, 3, 4, 5), (4, "smem"): (10, 11)}
ACC_REG_BUDGET = 96         # 32-bit registers a lane may give x, dy and dg/db
RING = 2                    # row buffers a group: the next row in flight (layer_norm.cu kRing)
PAIR_SMEM = 80 * 1024       # two blocks a SM up to this much shared memory each
PAIR_BLOCK_ROWS = 24        # and rows a block would own in two blocks a SM at least
SM_SMEM = 233472            # shared memory of an SM, 1 KB of it reserved a block
BLOCK_SMEM = 232448 - 128   # the most one block may take, less the kernel's static row sums


def ln_bwd_regs(slots: int, element_size: int, acc: str) -> int:
    """The 32-bit registers a lane of the rows kernel holds across a row:
    x and dy (4 each a 16-byte vector) and with ``acc`` 'regs' the fp32 dg
    and db of its columns."""
    per = 16 // element_size
    return slots * (8 + (2 * per if acc == "regs" else 0))


def ln_bwd_smem(plan: LnBwdPlan, element_size: int) -> int:
    """Dynamic shared memory of a rows-kernel block (layer_norm.cu
    `bwd_rows_launch`): the groups' row buffers (x, dy, and each lane's
    copy of the row's mu and rstd), g, and the
    accumulators (``acc`` 'smem') or the buffer the groups' sums meet in
    (more than one group)."""
    stride = 32 * plan.warps
    floats = stride * plan.slots * (16 // element_size)
    three = plan.acc == "smem" or plan.groups > 1
    ring = 16 * stride * (2 * plan.slots + 1) * plan.ring * plan.groups
    return ring + 4 * floats * (3 if three else 1)


def ln_bwd_plan(E: int, element_size: int, aligned: bool = True) -> LnBwdPlan:
    """The plan of :func:`layer_norm_bwd` for rows of E elements of
    ``element_size`` bytes; ``aligned``: every row of x, dy and dx and g
    start on a 16-byte boundary. At the arch table's widths a group of up
    to eight warps holds the row, about SLOTS_TARGET vectors a lane; dg and
    db stay in registers when :func:`ln_bwd_regs` keeps within
    ACC_REG_BUDGET, else in shared memory (a group of eight warps a block).
    A ring of RING row buffers a group where a block holds it, else none.
    Up to two register-plan blocks a SM where a block's shared memory stays
    within PAIR_SMEM (two larger blocks leave the SM's L1 under 96 KB: at
    fc2_ln, 12,288 x 3,072 bf16 on an H100, they ran 20% slower than one
    block); else one."""
    per = 16 // element_size
    if E not in LN_WIDTHS or not aligned:
        return LnBwdPlan("two_walk", vec=aligned and E % per == 0)
    nv = E // per
    warps = min(8, -(-nv // (32 * SLOTS_TARGET)))
    slots = -(-nv // (32 * warps))
    acc = "regs" if ln_bwd_regs(slots, element_size, "regs") <= ACC_REG_BUDGET else "smem"
    pair = LnBwdPlan("rows", warps, slots, acc, RING, 2)
    if acc == "regs" and ln_bwd_smem(pair, element_size) <= PAIR_SMEM:
        return pair
    for ring in (RING, 0):
        plan = LnBwdPlan("rows", warps, slots, acc, ring, 1)
        if ln_bwd_smem(plan, element_size) <= BLOCK_SMEM:
            return plan
    raise AssertionError(f"no B6-bwd plan fits E = {E}")


def ln_bwd_partition(N: int, plan: LnBwdPlan, sms: int) -> Tuple[int, int]:
    """(blocks, rows per block) of the backward's per-chunk pass: block k
    owns rows [k R, (k + 1) R) and writes one partial; all blocks launched
    at once (one wave). ``plan.sm_blocks`` blocks a SM where each would own
    at least PAIR_BLOCK_ROWS rows, else one: below that a block's fixed
    cost (g, its first rows' copies, the groups' sums, its partial) weighs
    more than the second block's latency hiding. On an H100 the two met at
    16-24 rows a block for E = 768 to 4,096; at 8 one block a SM ran the
    call 11-13% faster."""
    per_sm = plan.sm_blocks
    if N < sms * per_sm * PAIR_BLOCK_ROWS:
        per_sm = 1
    rows = max(1, -(-N // (sms * per_sm)))
    return -(-N // rows), rows


def bwd_launch(x, g, mu, rstd, dy, dx, dg, db, part, plan, rows, parts=3):
    """Launch B6-bwd's parts (1 the per-chunk pass into ``part``, 2 the
    reduction into dg and db, 3 both) on tensors the caller checked; counts
    nothing. Raises on a refused launch."""
    N, E = x.shape
    with torch.cuda.device(x.device):
        err = _bind("layer_norm_bwd")(
            _ptr(x), _ptr(g), _ptr(mu), _ptr(rstd), _ptr(dy), _ptr(dx), _ptr(dg), _ptr(db),
            _ptr(part), N, E, part.shape[0], rows, plan.warps, plan.slots,
            int(plan.acc == "smem"), plan.ring, int(plan.vec), _DTYPE_CODE[x.dtype], parts,
            _stream(x))
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd: CUDA launch failed with error {err}")


def bwd_setup(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor):
    """The plan, the partition and the outputs and scratch of one B6-bwd
    call on CUDA tensors: (plan, rows per block, dx, dg, db, part)."""
    N, E = x.shape
    dx = torch.empty_like(x)
    plan = ln_bwd_plan(E, x.element_size(), all(t.data_ptr() % 16 == 0 for t in (x, g, dy, dx)))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks, rows = ln_bwd_partition(N, plan, sms)
    dg = torch.empty((E,), dtype=torch.float32, device=x.device)
    db = torch.empty((E,), dtype=torch.float32, device=x.device)
    part = torch.empty((blocks, 2, E), dtype=torch.float32, device=x.device)
    return plan, rows, dx, dg, db, part


def layer_norm_bwd(x: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor,
                   dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B6-bwd: the gradients of B6-fwd for the cotangent ``dy`` (N, E)
    in x's dtype, given x, g and the forward's mu and rstd (N, 1) -> dx in
    x's dtype, dg and db (E,) fp32.

    CUDA tensors launch the kernel that :func:`ln_bwd_plan` picks (counted
    in ``layer_norm_bwd.launches``, one per call: the call runs the
    per-chunk pass and the reduction of its partials); CPU tensors run
    :func:`layer_norm_bwd_reference`."""
    stats = tuple(x.shape[:1]) + (1,)
    _check("layer_norm_bwd", x, g, (mu, stats, torch.float32), (rstd, stats, torch.float32),
           (dy, tuple(x.shape), x.dtype))
    if not x.is_cuda:
        return layer_norm_bwd_reference(x, g, mu, rstd, dy)
    with torch.cuda.device(x.device):
        plan, rows, dx, dg, db, part = bwd_setup(x, g, dy)
    bwd_launch(x, g, mu, rstd, dy, dx, dg, db, part, plan, rows)
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
        return self.normalize(x, self.weight, self.bias)

    def normalize(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The module's LayerNorm of ``x`` with the given weight and bias (a
        tensor-parallel shard passes the gathered whole ones)."""
        fn = HybridLayerNormFunction if self.mode == "hybrid" else FusedLayerNormFunction
        shape = x.shape
        y = fn.apply(x.reshape(-1, shape[-1]).contiguous(), weight, bias, self.eps)
        return y.reshape(shape).to(self.dtype)
