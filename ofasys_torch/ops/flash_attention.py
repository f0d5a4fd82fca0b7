"""Flash (blocked online-softmax) attention for long sequences: kernel B3
(forward) and the whole backward (kernels B4-dq, B4-dkv and B5 of
ofasys_tpu/ops/pallas_attention.py: dQ, dK/dV and the gradient of a bias
shared by the batch) as one pass, the counterpart of that file.

For CUDA tensors ``flash_attention_fwd`` launches the kernel of
``ofasys_torch/csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd`` the
one tensor-core pass of ``ofasys_torch/csrc/flash_attention_bwd.cu`` (dq,
dk, dv and the bias gradient together; :func:`backward_plan` sizes its
launch and scratch); ``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``
and ``flash_attention_bwd_dbias`` return their parts of that pass. For CPU
tensors each runs its plain version (:func:`flash_attention_fwd_reference`,
:func:`flash_attention_bwd_reference`). There is no other route: on a CUDA
tensor each launches its kernel or raises. :class:`FlashAttentionFunction`
joins them as one autograd function, as ``flash_attention_flat``'s custom
vjp does in JAX, and also returns the lse with its cotangent
(``flash_attention_with_lse``).

Kernel-level tensors keep the projections' layout: q, out, do (B, Tq, E)
and k, v (B, Tk, E) with E = H * D (the kernels slice the heads); lse and dd
fp32 (B, H, Tq); bias bf16 (H, Tq, Tk) shared by the batch or (B * H, Tq, Tk)
one matrix per (b, h); mask int8 (B, 1, Tk) keep-mask. ``causal`` needs
Tq == Tk and is start-aligned (key j <= query i), as the TPU kernel masks.
The kernels take bf16 q/k/v, the model's compute dtype on the card; fp32
runs only through the plain versions, on the CPU.

The TPU wrapper's Mosaic/VMEM switches (``OFASYS_FLASH_EXP``,
``OFASYS_FLASH_BQ*``/``BK*``, ``OFASYS_FLASH_XLA_BWD``, ``layout='bhtd'``) and
its pad of Tq to 16 and Tk to 128 are not carried over: the kernels take
ragged tails themselves and there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ofasys_torch.ops.attention import MASK_VALUE

_CPU_DTYPES = (torch.bfloat16, torch.float32)   # the kernels take bf16 only


def flash_available(device) -> bool:
    """Whether the flash kernels run for tensors on ``device`` (ofasys_tpu's
    ``_flash_available()``): on CUDA. Elsewhere the model takes the plain
    attention path, as ofasys_tpu does off the TPU."""
    return torch.device(device).type == "cuda"


def flash_supported(Tq: int, Tk: int, D: int, dropout_rate: float) -> bool:
    """The shapes ofasys_tpu sends to its flash kernel: no attention
    dropout (it is not fused), D <= 256, Tq >= 16 and Tk >= 256."""
    if dropout_rate > 0.0:
        return False
    if D > 256:
        return False
    return Tq >= 16 and Tk >= 256


# ------------------------------------------------------------ backward plan
# The backward pass's fp32 scratch (the dq partials of its key ranges, and
# the chunk partials of a shared bias's gradient) is held under this many
# bytes each: past it the samples, and for one long sample the key ranges,
# go in groups launched one after the other.
SCRATCH_CAP = 256 << 20
H100_SMS = 132

# the block of the tensor-core backward (csrc/dense_attention_bwd_mma.cuh):
# 32 query rows a step, at most 256 keys, 227 KB of shared memory
_Q_TILE, _MAX_RANGE, _MAX_SMEM = 32, 256, 232448


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(KR: int, D: int) -> int:
    """Shared memory of a block whose range holds KR keys (``smem_bytes`` of
    the header): K, V, q, do and ds^T tiles in bf16, the fp32 dK and dV sums,
    lse, dd, the warps' dd parts and the keep-mask."""
    krp, ld, dacc = _round_up(KR, 16), _round_up(D, 16) + 8, _round_up(D, 32)
    return (2 * (2 * krp * ld + 2 * _Q_TILE * ld + krp * (_Q_TILE + 8)) + 4 * (2 * krp * dacc)
            + 4 * (2 + 8) * _Q_TILE + krp)


def max_key_range(Tk: int, D: int) -> int:
    """Keys per block at most: all Tk when a block's sums fit, else the
    largest multiple of 16 that fits (``key_range`` of the header; the C
    entry ``flash_attention_bwd_max_key_range`` gives the same)."""
    for KR in range(min(_round_up(Tk, 16), _MAX_RANGE), 0, -16):
        if _smem_bytes(KR, D) <= _MAX_SMEM:
            return min(KR, Tk)
    return 0


class BackwardPlan(NamedTuple):
    """How one backward call is launched: ``key_range`` keys per block
    (``ranges`` of them cover Tk), ``chunks`` blocks along the samples of a
    group of ``group_samples`` samples, ``group_ranges`` ranges per launch,
    and the fp32 scratch in elements (``dq_scratch``: the ranges' dq
    partials, plus the running dq sum when the ranges come in groups;
    ``dbias_scratch``: a shared bias's chunk partials)."""
    key_range: int
    ranges: int
    chunks: int
    group_samples: int
    group_ranges: int
    dq_scratch: int
    dbias_scratch: int


def backward_plan(B: int, H: int, Tq: int, Tk: int, D: int, shared_dbias: bool,
                  sms: int = H100_SMS, cap: int = SCRATCH_CAP) -> BackwardPlan:
    """The launch of :func:`flash_attention_bwd` for one shape.

    Key ranges: as few as the shared memory allows, of equal size (a
    multiple of 16), so the last range is not a sliver. Each range writes
    an fp32 dq partial of its samples, Tq * E * 4 bytes each; past ``cap``
    the samples go in groups of equal size (one sample at the least), and a
    sample whose partials alone pass it has its ranges in groups too, with
    one more slot for the running fp32 sum.

    Chunks: one block takes a (range, head, chunk of samples) and one block
    fills an SM (8 warps, about 220 registers each), so a group runs in
    ceil(ranges * H * chunks / sms) waves of ceil(samples / chunks) samples
    each; the fewest chunks that reach the least of that product. A shared
    bias's gradient needs one fp32 (H, Tq, Tk) partial per chunk (none
    with one chunk), held under ``cap`` as well."""
    E = H * D
    top = max_key_range(Tk, D)
    if top == 0:
        raise ValueError(f"flash_attention_bwd: no key range fits at D={D}")
    ranges = -(-Tk // top)
    key_range = Tk if ranges == 1 else _round_up(-(-Tk // ranges), 16)
    ranges = -(-Tk // key_range)
    group_samples, group_ranges, dq_scratch = B, ranges, 0
    if ranges > 1:
        per_sample = ranges * Tq * E * 4
        if B * per_sample > cap:
            groups = -(-B // max(1, cap // per_sample))
            group_samples = -(-B // groups)
        if per_sample > cap:
            group_ranges = max(1, cap // (Tq * E * 4) - 1)
        dq_scratch = (group_ranges + (group_ranges < ranges)) * group_samples * Tq * E
    bias_part = H * Tq * Tk * 4

    def waves(c):
        return -(-(group_ranges * H * c) // sms) * -(-group_samples // c)

    allowed = [c for c in range(1, group_samples + 1)
               if c == 1 or not shared_dbias or c * bias_part <= cap]
    # the fewest chunks of the least cost: no chunk is left empty, since the
    # chunks that hold as many samples each and leave none empty cost no more
    chunks = min(allowed, key=lambda c: (waves(c), c))
    dbias_scratch = chunks * H * Tq * Tk if shared_dbias and chunks > 1 else 0
    return BackwardPlan(key_range, ranges, chunks, group_samples, group_ranges, dq_scratch,
                        dbias_scratch)


# --------------------------------------------------------------- plain versions
def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, T, E = t.shape
    return t.reshape(B, T, H, E // H).permute(0, 2, 1, 3).float()     # (B, H, T, D)


def _unheads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(B, T, H * D).to(dtype)


def _scores(q, k, bias, mask, H, scale, causal) -> torch.Tensor:
    """fp32 (B, H, Tq, Tk) scores as the kernels form them: (q.k) * scale,
    plus the bias, -1e9 on masked keys and above the causal diagonal."""
    B, Tq, _ = q.shape
    Tk = k.shape[1]
    s = torch.matmul(_heads(q, H), _heads(k, H).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float().reshape(-1, H, Tq, Tk)     # (1 or B, H, Tq, Tk)
    neg = torch.full((), MASK_VALUE, device=s.device)
    if mask is not None:
        s = torch.where(mask[:, None] != 0, s, neg)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, neg)
    return s


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor], num_heads: int, scale: float, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B3 (whole rows instead of tiles): fp32
    scores, p = exp(s - max) rounded to v's dtype before p.V with an fp32
    sum, l the sum of the unrounded p, out = acc / max(l, 1e-30) in q's
    dtype and lse = max + log(max(l, 1e-30)) fp32 (B, H, Tq)."""
    s = _scores(q, k, bias, mask, num_heads, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), _heads(v, num_heads))
    return _unheads(acc / l, q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    dd: torch.Tensor, bias: Optional[torch.Tensor], mask: Optional[torch.Tensor],
    num_heads: int, scale: float, causal: bool, want_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch twin of kernels B4 and B5, in their arithmetic (not
    autograd of the forward): p = exp(s - lse), dp = do.v^T, ds = p (dp - dd)
    in fp32, dq = scale round(ds).k, dk = scale round(ds)^T.q,
    dv = round(p)^T.do with round() to q's dtype. The bias gradient is ds
    itself, fp32 (B * H, Tq, Tk), for a per-(b, h) bias (the dq kernel's
    output) and the fp32 batch sum of ds, (H, Tq, Tk), for a shared one
    (kernel B5); None without a bias or when ``want_dbias`` is False."""
    H = num_heads
    B, Tq, _ = q.shape
    dt = q.dtype
    s = _scores(q, k, bias, mask, H, scale, causal)
    p = torch.exp(s - lse[..., None])
    doh = _heads(do, H)
    dp = torch.matmul(doh, _heads(v, H).transpose(-1, -2))
    ds = p * (dp - dd[..., None])
    dsb = ds.to(dt).float()
    dq = torch.matmul(dsb, _heads(k, H)) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), _heads(q, H)) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    dbias = None
    if bias is not None and want_dbias:
        dbias = ds.reshape(B * H, Tq, -1) if bias.shape[0] == B * H else ds.sum(0)
    return _unheads(dq, dt), _unheads(dk, dt), _unheads(dv, dt), dbias


# ------------------------------------------------------------------ wrappers
def _check(q, k, v, bias, mask, num_heads, causal, name):
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in _CPU_DTYPES \
            or (q.is_cuda and q.dtype != torch.bfloat16):
        raise TypeError(f"{name}: q/k/v must share bf16 (fp32 only on the CPU), got "
                        f"{q.dtype}/{k.dtype}/{v.dtype} on {q.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,Tq,E), k and v (B,Tk,E) expected")
    B, Tq, E = q.shape
    Tk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != E or E % num_heads:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} heads {num_heads}")
    D = E // num_heads
    if not (B > 0 and Tq > 0 and Tk > 0 and 0 < D <= 256):
        raise ValueError(f"{name}: needs non-empty q and k and D <= 256, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} D={D}")
    if causal and Tq != Tk:
        raise ValueError(f"{name}: causal requires Tq == Tk")
    if bias is not None and (bias.dtype != torch.bfloat16 or bias.dim() != 3
                             or bias.shape[0] not in (num_heads, B * num_heads)
                             or tuple(bias.shape[1:]) != (Tq, Tk)):
        raise ValueError(f"{name}: bias must be bf16 (H or B*H, Tq, Tk)")
    if mask is not None and (mask.dtype != torch.int8 or tuple(mask.shape) != (B, 1, Tk)):
        raise ValueError(f"{name}: mask must be int8 (B, 1, Tk)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_bwd(q, do, lse, dd, num_heads, name):
    B, Tq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(f"{name}: do must be contiguous, shaped and typed as q")
    for label, t in (("lse", lse), ("dd", dd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, num_heads, Tq) \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous fp32 (B, H, Tq)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _bind(lib_name: str, fn_name: str, n_ptrs: int, n_ints: int):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu``: n_ptrs pointers,
    n_ints ints, the float scale and the stream."""
    from ofasys_torch.ops.cuda_build import load

    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _dims(q, k, bias, num_heads):
    B, Tq, E = q.shape
    per_bh = int(bias is not None and bias.shape[0] == B * num_heads)
    return B, num_heads, Tq, k.shape[1], E // num_heads, per_bh


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor], num_heads: int, scale: float, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3: q (B, Tq, E), k/v (B, Tk, E), bias bf16 (H or B*H, Tq, Tk)
    or None, mask int8 (B, 1, Tk) or None -> out (B, Tq, E) in q's dtype and
    lse (B, H, Tq) fp32.

    CUDA tensors launch the kernel (counted in ``flash_attention_fwd.launches``);
    CPU tensors run :func:`flash_attention_fwd_reference`."""
    _check(q, k, v, bias, mask, num_heads, causal, "flash_attention_fwd")
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, bias, mask, num_heads, scale, causal)
    fn = _bind("flash_attention_fwd", "flash_attention_fwd", 7, 7)
    B, H, Tq, Tk, D, per_bh = _dims(q, k, bias, num_heads)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(mask), _ptr(out), _ptr(lse),
                 B, H, Tq, Tk, D, per_bh, int(causal), scale, _stream(q))
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(
    q, k, v, do, lse, dd, bias, mask, num_heads: int, scale: float, causal: bool,
    want_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The whole backward (``_flash_backward``, kernels B4-dq, B4-dkv and
    B5): the arguments of :func:`flash_attention_fwd` plus the output
    cotangent ``do`` (B, Tq, E), the forward's lse and dd = rowsum(do * out)
    minus the lse cotangent (both fp32 (B, H, Tq)) -> dq (B, Tq, E), dk, dv
    (B, Tk, E) in q's dtype and the bias gradient: ds itself, fp32
    (B * H, Tq, Tk), for a per-(b, h) bias and the fp32 batch sum of ds,
    (H, Tq, Tk), for a shared one, as ofasys_tpu routes them (a batch of one
    counts as per-(b, h)); None without a bias or when ``want_dbias`` is
    False.

    CUDA tensors launch the one tensor-core pass (counted in
    ``flash_attention_bwd.launches``) as :func:`backward_plan` lays it out,
    with fp32 scratch from ``torch.empty``: the key ranges' dq partials,
    (group_ranges [+ 1]) * group_samples * Tq * E * 4 bytes, and a shared
    bias's chunk partials, chunks * H * Tq * Tk * 4 bytes, each under
    ``SCRATCH_CAP`` (256 MiB) but where one sample's single range partial
    and running sum pass it. CPU tensors run
    :func:`flash_attention_bwd_reference`."""
    name = "flash_attention_bwd"
    _check(q, k, v, bias, mask, num_heads, causal, name)
    _check_bwd(q, do, lse, dd, num_heads, name)
    if not q.is_cuda:
        return flash_attention_bwd_reference(q, k, v, do, lse, dd, bias, mask, num_heads,
                                             scale, causal, want_dbias)
    B, H, Tq, Tk, D, per_bh = _dims(q, k, bias, num_heads)
    want_dbias = want_dbias and bias is not None
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = backward_plan(B, H, Tq, Tk, D, want_dbias and not per_bh, sms, SCRATCH_CAP)
    fn = _bind("flash_attention_bwd", name, 14, 11)
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dbias = torch.empty(tuple(bias.shape), dtype=torch.float32, device=q.device) \
            if want_dbias else None
        dq_part, part = (torch.empty(n, dtype=torch.float32, device=q.device) if n else None
                         for n in (plan.dq_scratch, plan.dbias_scratch))
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(dd), _ptr(bias), _ptr(mask),
                 _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias), _ptr(part), _ptr(dq_part),
                 B, H, Tq, Tk, D, per_bh, int(causal), plan.key_range, plan.chunks,
                 plan.group_samples, plan.group_ranges, scale, _stream(q))
    _raise_on(err, name)
    flash_attention_bwd.launches += 1
    return dq, dk, dv, dbias


flash_attention_bwd.launches = 0


def flash_attention_bwd_dq(
    q, k, v, do, lse, dd, bias, mask, num_heads: int, scale: float, causal: bool,
    want_ds: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel B4-dq's part of the backward: arguments as
    :func:`flash_attention_bwd` -> dq (B, Tq, E) in q's dtype, and with
    ``want_ds`` (a per-(b, h) bias only) ds fp32 (B * H, Tq, Tk).

    CUDA tensors run the one pass of :func:`flash_attention_bwd` (counted
    there; this launches nothing of its own) and return its dq and ds; CPU
    tensors run the dq part of :func:`flash_attention_bwd_reference`."""
    name = "flash_attention_bwd_dq"
    _check(q, k, v, bias, mask, num_heads, causal, name)
    _check_bwd(q, do, lse, dd, num_heads, name)
    if want_ds and not _dims(q, k, bias, num_heads)[5]:
        raise ValueError(f"{name}: ds is the gradient of a per-(b, h) bias (B*H, Tq, Tk)")
    dq, _, _, ds = flash_attention_bwd(q, k, v, do, lse, dd, bias, mask, num_heads, scale,
                                       causal, want_dbias=want_ds)
    return dq, ds


def flash_attention_bwd_dkv(
    q, k, v, do, lse, dd, bias, mask, num_heads: int, scale: float, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4-dkv's part of the backward: arguments as
    :func:`flash_attention_bwd` -> dk, dv (B, Tk, E) in k's dtype.

    CUDA tensors run the one pass of :func:`flash_attention_bwd` (counted
    there) and return its dk and dv; CPU tensors run the dk/dv part of
    :func:`flash_attention_bwd_reference`."""
    _, dk, dv, _ = flash_attention_bwd(q, k, v, do, lse, dd, bias, mask, num_heads, scale,
                                       causal, want_dbias=False)
    return dk, dv


def flash_attention_bwd_dbias(
    q, k, v, do, lse, dd, bias, mask, num_heads: int, scale: float, causal: bool,
) -> torch.Tensor:
    """Kernel B5's part of the backward: the gradient of a bias (H, Tq, Tk)
    shared by the batch, sum_b p_b (dp_b - dd_b) in fp32 (H, Tq, Tk);
    arguments as :func:`flash_attention_bwd`.

    CUDA tensors run the one pass of :func:`flash_attention_bwd` (counted
    there) and return its bias gradient; CPU tensors run the dbias part of
    :func:`flash_attention_bwd_reference`."""
    name = "flash_attention_bwd_dbias"
    _check(q, k, v, bias, mask, num_heads, causal, name)
    if bias is None or bias.shape[0] != num_heads:
        raise ValueError(f"{name}: needs a bias (H, Tq, Tk) shared by the batch")
    return flash_attention_bwd(q, k, v, do, lse, dd, bias, mask, num_heads, scale, causal)[3]


class FlashAttentionFunction(torch.autograd.Function):
    """Kernel B3 forward, the one backward pass of B4-dq, B4-dkv and B5
    backward (the custom vjp of ``flash_attention_flat`` and
    ``flash_attention_with_lse``): q (B, Tq, E), k/v (B, Tk, E), bias bf16
    (H or B*H, Tq, Tk) or None, mask int8 (B, 1, Tk) or None -> (out
    (B, Tq, E), lse (B, H, Tq) fp32). The lse
    cotangent folds into the backward as dd - g_lse; the bias gradient
    comes back in the bias's dtype, as ``_bwd`` returns it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, num_heads, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, bias, mask, num_heads, scale, causal)
        ctx.save_for_backward(q, k, v, bias, mask, out, lse)
        ctx.args = (num_heads, scale, causal)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, mask, out, lse = ctx.saved_tensors
        num_heads, scale, causal = ctx.args
        B, Tq, E = q.shape
        do = torch.zeros_like(out) if g_out is None else g_out.contiguous()
        # dd = rowsum(do * out), outside the kernels as in _flash_backward
        dd = (do.float() * out.float()).reshape(B, Tq, num_heads, E // num_heads).sum(-1)
        dd = dd.permute(0, 2, 1)
        if g_lse is not None:
            dd = dd - g_lse.float()
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, do, lse, dd.contiguous(), bias, mask, num_heads, scale, causal,
            want_dbias=ctx.needs_input_grad[3],
        )
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    mask: Optional[torch.Tensor], num_heads: int, scale: float, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Tq, E), lse (B, H, Tq) fp32), both differentiable; the
    kernel-level arguments of :class:`FlashAttentionFunction` (ring
    attention's online merge needs the lse)."""
    return FlashAttentionFunction.apply(q, k, v, bias, mask, num_heads, scale, causal)


def flash_attention(
    q: torch.Tensor,                       # (B, Tq, H, D)
    k: torch.Tensor,                       # (B, Tk, H, D)
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,   # (1|B, H, Tq, Tk) additive
    mask: Optional[torch.Tensor] = None,   # bool/int8 (B|1, 1, 1, Tk) keep-mask
    scale: float = 1.0,
    causal: bool = False,
) -> torch.Tensor:
    """Long-sequence attention through kernels B3, B4 and B5, the port of
    ofasys_tpu's ``flash_attention`` (no-dropout path). The prep stays
    visible to autograd: the bias is rounded to bf16 (so an fp32 bias gets
    its gradient through that cast), kept (H, Tq, Tk) when the batch
    shares it and (B * H, Tq, Tk) otherwise. Causal needs Tq == Tk."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if causal and Tq != Tk:
        raise ValueError("flash_attention causal requires Tq == Tk")
    bf = None
    if bias is not None:
        bias = bias.to(torch.bfloat16)
        if bias.shape[0] == 1:
            bf = bias[0].expand(H, Tq, Tk).contiguous()
        else:
            bf = bias.expand(B, H, Tq, Tk).reshape(B * H, Tq, Tk).contiguous()
    mf = None
    if mask is not None:
        mf = mask.to(torch.int8).expand(B, 1, 1, Tk).reshape(B, 1, Tk).contiguous()
    out, _ = FlashAttentionFunction.apply(
        q.reshape(B, Tq, H * D).contiguous(), k.reshape(B, Tk, H * D).contiguous(),
        v.reshape(B, Tk, H * D).contiguous(), bf, mf, H, float(scale), bool(causal),
    )
    return out.reshape(B, Tq, H, D)
