"""Chip smoke test of ofasys_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build: every CUDA kernel of ofasys_torch/csrc, one nvcc each, in parallel
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving and training paths give it, with times (CUDA
     events, median), the library call's time and the bound
  4. serve: text→text serving at the base arch's full width (E=768, 12 heads,
     6+6 layers) with a 50,000-symbol text vocabulary, random weights from a
     seed: 16 requests through InferenceServer -> OFASys.inference ->
     SequenceGenerator, with the kernel launch counts of that run
  5. profile: one serving dispatch under torch.profiler (device busy and
     idle share, the kernels that take the most device time)
  6. train: 5 summed two-task updates (text_infilling B=128 with span
     masking, gigaword B=64) through make_multitask_train_step at the same
     width, dropout 0.1, adamw with clipping, with the kernel launch counts
     of that run, a falling loss, and one update's gradients under the
     kernels against the plain attention path
  7. profile: one training update under torch.profiler
Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX or ofasys_tpu. Exits non-zero without CUDA.

The train phase can be rehearsed on the CPU at a tiny arch, where the
kernels' plain versions stand in and no launch is counted:
``train_and_check(build_train_model(d, "cpu", arch="tiny"), gp, "cpu",
tasks=TINY_TRAIN_TASKS)``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

SEED = 0
TPL = "[TEXT:src] -> [TEXT:tgt]"
N_BEAM_REQUESTS = 12          # the hub's TEXT defaults: beam 5, no-repeat 3-grams
N_GREEDY_REQUESTS = 4         # beam_size=1
MAX_LEN_B = 16
# bf16 tolerances. Kernel vs plain version: p is rounded to bf16 before p.V
# at a different point (unnormalized vs normalized) -> out atol 2e-2; lse is
# an fp32 sum of the same products in another order -> atol 1e-3.
OUT_ATOL = 2e-2
LSE_ATOL = 1e-3
# Encoder output, kernel vs plain attention through 6 bf16 layers: the plain
# path rounds scores to bf16 before the softmax (attn_logits='compute'), the
# kernel keeps them fp32, so the two differ by bf16 rounding carried through
# the stack: relative Frobenius error <= 2e-2 and max abs <= 0.25 (final-LN
# outputs of order 1; a bf16 ulp at 4 is 0.03).
ENC_REL_TOL = 2e-2
ENC_ABS_TOL = 0.25
# Kernel B2 vs its plain version (bf16): dq, dk, dv within 2e-2 of the
# largest entry (bf16 outputs; p and ds are rounded to bf16 before their
# products on both sides, and a value on a rounding boundary can round
# either way after a reordered fp32 sum); dbias, an fp32 batch sum of
# unrounded ds, within 1e-3 of its largest entry.
BWD_REL_ATOL = 2e-2
DBIAS_REL_ATOL = 1e-3

# the training slice: ofasys_tpu's task zoo templates (task/tasks.py)
INFILL_TPL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY_TPL = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
# batch and text lengths in bytes (the byte tokenizer: one token each):
# text_infilling targets of about 64 tokens (bench.py's infilling shape),
# gigaword sources that give the encoder about 190 tokens and summaries of
# about 24
TRAIN_TASKS = {
    "text_infilling": dict(template=INFILL_TPL, batch=128, text=(58, 62)),
    "gigaword": dict(template=SUMMARY_TPL, batch=64, src=(140, 150), tgt=(20, 24)),
}
TINY_TRAIN_TASKS = {
    "text_infilling": dict(template=INFILL_TPL, batch=4, text=(58, 62)),
    "gigaword": dict(template=SUMMARY_TPL, batch=2, src=(140, 150), tgt=(20, 24)),
}
N_UPDATES = 5
TRAIN_LR = 1e-4
# One update's gradients (dropout 0) under the kernels vs the plain
# attention path: the plain path rounds the scores to bf16 before the
# softmax (attn_logits='compute') and the kernels keep them fp32, so the two
# differ by bf16 rounding carried through 12 layers forward and back. The
# key-side biases (k_proj, pos_k_linear, cross_pos_k_linear) shift every
# score of a softmax row alike: their gradient is 0 in exact arithmetic and
# rounding noise on both paths, so the per-leaf check leaves them out.
GRAD_REL_TOL = 5e-2
LEAF_REL_TOL = 0.25
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, n: int = 50, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``n`` back-to-back
    calls. A GPU sleep first lets the host queue the calls ahead, so the
    events bracket device work and not Python launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


# ------------------------------------------------------------------ phases
def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi name, power.limit: {smi}")
    return name, smi


def phase_build():
    from ofasys_torch.ops import cuda_build

    names = sorted(p[:-3] for p in os.listdir(cuda_build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    reports = cuda_build.build(names)
    secs = time.perf_counter() - t0
    log(f"build: {names} in {secs:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return names


def _dense_inputs(B, Tq, Tk, H, D, seed, causal=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * 0.125).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g)
    if causal:                                # folded into the bias, as the wrapper does
        cm = torch.ones(Tq, Tk, device="cuda").tril(Tk - Tq).bool()
        bias = torch.where(cm, bias, torch.full((), -1e9, device="cuda"))
    bias = bias.to(torch.bfloat16)
    keep = torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.2
    for b in range(1, B):                     # padding-style tails
        keep[b, :, max(1, Tk - 3 * b):] = False
    keep[:, :, 0] = True                      # no fully-masked query row
    do = torch.randn(B, Tq, H * D, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, bias, keep.to(torch.int8), do


def _fwd_bound(B, Tq, Tk, H, D):
    """Bytes (q, k, v, bias, mask read once; out, lse written once) and
    FLOPs (q.k and p.v) of kernel B1."""
    n_bytes = 2 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + H * Tq * Tk) + B * Tk + 4 * B * H * Tq
    return n_bytes, 4 * B * H * Tq * Tk * D


def _bwd_bound(B, Tq, Tk, H, D, with_bias=True):
    """Bytes (q, k, v, do, lse, bias, mask read once; dq, dk, dv, dbias
    written once) and FLOPs (the TPU kernel's CostEstimate, 10 B Tq Tk E)
    of kernel B2."""
    E = H * D
    n_bytes = 2 * (2 * B * Tq * E + 2 * B * Tk * E) + 2 * (B * Tq * E + 2 * B * Tk * E) \
        + 4 * B * H * Tq + B * Tk + (2 + 4) * H * Tq * Tk * with_bias
    return n_bytes, 10 * B * Tq * Tk * E


def _bound(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_args(q, k, v, bias, mask, H, D, grad=False):
    """The same function for one library call: (B, H, T, D) views and an
    additive bias with the mask folded in as -1e9."""
    add = (bias[None].float() + torch.where(mask[:, :, None, :] != 0, 0.0, -1e9)).to(torch.bfloat16)
    q4, k4, v4 = (t.view(t.shape[0], t.shape[1], H, D).transpose(1, 2) for t in (q, k, v))
    if grad:
        q4, k4, v4, add = (t.detach().clone().requires_grad_() for t in (q4, k4, v4, add))
    return q4, k4, v4, add


def check_fwd(label, shape, causal=False):
    """Kernel B1 against its plain version at one shape, with its times."""
    import torch.nn.functional as F

    from ofasys_torch.ops.dense_attention import dense_attention_fwd, dense_attention_fwd_reference

    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, _ = _dense_inputs(B, Tq, Tk, H, D, SEED, causal)
    out, lse = dense_attention_fwd(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    ref, ref_lse = dense_attention_fwd_reference(q, k, v, bias, mask, H)
    err_out = (out.float() - ref.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    log(f"kernel dense_attention_fwd [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}]: "
        f"max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) max|lse-plain|={err_lse:.3e} "
        f"(atol {LSE_ATOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_fwd disagrees with its plain version at {label}")
    q4, k4, v4, add = _sdpa_args(q, k, v, bias, mask, H, D)
    kernel_ms = time_ms(lambda: dense_attention_fwd(q, k, v, bias, mask, H))
    plain_ms = time_ms(lambda: dense_attention_fwd_reference(q, k, v, bias, mask, H))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0))
    n_bytes, flops = _fwd_bound(B, Tq, Tk, H, D)
    bound_ms, bound_by = _bound(n_bytes, flops)
    log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return dict(shape=label, B=B, Tq=Tq, Tk=Tk, err_out=err_out, err_lse=err_lse,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _sdpa_bwd_ms(q4, k4, v4, add, do4):
    """The library yardstick of B2: autograd through scaled_dot_product_attention
    with a float mask that requires grad (the memory-efficient backend's
    backward with a bias gradient), minus its forward."""
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q4, k4, v4, add), do4)

    try:
        both = time_ms(fwd_bwd, n=20)
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library backward not timed: {str(e).splitlines()[0][:120]}")
        return None
    with torch.no_grad():
        return both - time_ms(fwd, n=20)


def check_bwd(label, shape, causal=False):
    """Kernel B2 against its plain version at one shape, with its times."""
    from ofasys_torch.ops.dense_attention import (
        dense_attention_bwd,
        dense_attention_bwd_reference,
        dense_attention_fwd,
    )

    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, do = _dense_inputs(B, Tq, Tk, H, D, SEED, causal)
    _, lse = dense_attention_fwd(q, k, v, bias, mask, H)
    got = dense_attention_bwd(q, k, v, do, lse, bias, mask, H)
    torch.cuda.synchronize()
    ref = dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H)
    errs, ok = {}, True
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item())
        errs[name] = err
        tol = (DBIAS_REL_ATOL if name == "dbias" else BWD_REL_ATOL) * scale
        ok = ok and bool(torch.isfinite(a.float()).all()) and err <= tol
    log(f"kernel dense_attention_bwd [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}]: "
        + " ".join(f"max|{n}-plain|={e:.3e}" for n, e in errs.items())
        + f" (dq/dk/dv atol {BWD_REL_ATOL} x max(1, |plain|), dbias {DBIAS_REL_ATOL} x) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_bwd disagrees with its plain version at {label}")
    q4, k4, v4, add = _sdpa_args(q, k, v, bias, mask, H, D, grad=True)
    do4 = do.view(B, Tq, H, D).transpose(1, 2)
    kernel_ms = time_ms(lambda: dense_attention_bwd(q, k, v, do, lse, bias, mask, H), n=20)
    plain_ms = time_ms(lambda: dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H), n=20)
    library_ms = _sdpa_bwd_ms(q4, k4, v4, add, do4)
    n_bytes, flops = _bwd_bound(B, Tq, Tk, H, D)
    bound_ms, bound_by = _bound(n_bytes, flops)
    lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention backward) {lib}, bound {bound_ms:.5f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return dict(shape=label, B=B, Tq=Tq, Tk=Tk, err=max(errs.values()), errs=errs,
                kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(dispatch_shapes, train_shapes):
    """Kernel B1 at the serving path's encoder shapes (one per planned
    dispatch), the nominal serving shape B=8 T=128 and every training
    shape; kernel B2 at every training shape; both at a ragged cross shape
    and at B=1. Base arch H=12, D=64. ``train_shapes`` is
    [(label, (B, Tq, Tk), causal)]."""
    fwd, bwd = [], []
    for i, (B, T) in enumerate(dispatch_shapes):
        fwd.append(check_fwd(f"dispatch{i}", (B, T, T, 12, 64)))
    fwd.append(check_fwd("serving", (8, 128, 128, 12, 64)))
    extra = [("ragged_cross", (3, 24, 200), False), ("B1", (1, 64, 64), False)]
    for label, (B, Tq, Tk), causal in list(train_shapes) + extra:
        fwd.append(check_fwd(label, (B, Tq, Tk, 12, 64), causal))
        bwd.append(check_bwd(label, (B, Tq, Tk, 12, 64), causal))
    return fwd, bwd


class RecordingHub:
    """Passes ``inference`` through to the hub and records each dispatch the
    server makes, so the same batches can be replayed directly."""

    def __init__(self, hub):
        self.hub = hub
        self.device = hub.device
        self.calls = []

    def inference(self, instruction, data=None, **kw):
        out = self.hub.inference(instruction, data, **kw)
        self.calls.append((instruction, data, kw, out))
        return out


def _requests():
    """The 16 requests of the serving run: (data, generation overrides)."""
    srcs = _sources(np.random.default_rng(SEED), N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    reqs = [({"src": s}, {"max_len_b": MAX_LEN_B}) for s in srcs[:N_BEAM_REQUESTS]]
    reqs += [({"src": s}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for s in srcs[N_BEAM_REQUESTS:]]
    return reqs


def _encoder_shape(gp, recs):
    from ofasys_torch.preprocessor.instruction import Instruction

    sample = gp.collate([gp(Instruction(TPL, split="test").format(**r)) for r in recs])
    return tuple(sample["net_input"]["slots"][0].value["inputs"].shape)


def planned_dispatch_shapes():
    """(B, T) of the encoder in each dispatch the server will make: the
    first 8 beam requests, the other 4 beam requests, the 4 greedy ones."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    gp = GeneralPreprocess(Dictionary(), active=["text"])
    recs = [r for r, _ in _requests()]
    groups = (recs[:8], recs[8:N_BEAM_REQUESTS], recs[N_BEAM_REQUESTS:])
    return [_encoder_shape(gp, g) for g in groups]


def _sources(rng, n):
    words = ["the", "model", "serves", "a", "batch", "of", "text", "requests", "on", "one", "card",
             "with", "beam", "search", "and", "greedy", "decoding", "over", "fifty", "thousand",
             "symbols", "quick", "brown", "fox", "jumps", "lazy", "dog", "12", "345", "north"]
    lengths = rng.integers(40, 201, size=n)
    # the first request of the 2nd and 3rd dispatch (4 records each) is long,
    # so every dispatch has B*T >= 256 and meets kernel B1's gate
    lengths[N_BEAM_REQUESTS - 4] = lengths[N_BEAM_REQUESTS] = 160
    out = []
    for L in lengths:
        s = ""
        while len(s) < L:
            s += rng.choice(words) + " "
        out.append(s[:L].strip().ljust(L, "x"))
    return out


def _expected_launches(gp, calls, n_layers):
    """Kernel-B1 launches the dispatches should make: one per encoder layer
    when the batch meets the gate (B*T >= 256, T <= 256)."""
    total = []
    for _, data, _, _ in calls:
        B, T = _encoder_shape(gp, data if isinstance(data, list) else [data])
        total.append((B, T, n_layers if B * T >= 256 and T <= 256 else 0))
    return total


def build_base_hub():
    """The base arch at full width (E=768, FFN 3072, 12 heads, 6+6 layers)
    with 50,000 ``<text>_i`` symbols padded to a multiple of 128, random
    weights from SEED, bf16 compute on the card."""
    from ofasys_torch import GeneralistModel, OFASys
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    t0 = time.perf_counter()
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text"])       # registers <text>_0..255 and <mask>
    for i in range(256, 50000):                       # GPT-2-scale text vocabulary
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(128)
    model = GeneralistModel(arch="base")
    model.cfg.dropout = 0.0
    model.initialize(d, active_adaptors=("text",), dtype=torch.bfloat16, device="cuda", seed=SEED)
    hub = OFASys(model, None, d, gp)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"slice: base arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} params={n_params} built in {time.perf_counter() - t0:.1f} s")
    return hub


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_and_check(hub, card):
    """Drive the serving path with the 16 requests and check what comes out;
    returns the kernel launch counts of that run."""
    from ofasys_torch.ops.dense_attention import dense_attention_fwd
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.serve import InferenceServer
    from ofasys_torch.utils.pytree import slots_to_device

    gp, model = hub.general_preprocess, hub.model
    cfg = model.cfg
    reqs = _requests()

    # warm-up (cuBLAS handles, allocator) outside the measured run
    hub.inference(TPL, [r for r, _ in reqs[:8]], max_len_b=4)
    hub.inference(TPL, [r for r, _ in reqs[:4]], max_len_b=4, beam_size=1)
    _sync(hub.device)

    rec = RecordingHub(hub)
    srv = InferenceServer(rec, max_batch=8, max_wait_ms=50.0, device=hub.device)
    try:
        dense_attention_fwd.launches = 0
        t_start = time.perf_counter()
        futs = [srv.submit(TPL, data, **opts) for data, opts in reqs]
        outs = [f.result(timeout=600) for f in futs]
        _sync(hub.device)
        wall = time.perf_counter() - t_start
        launches = dense_attention_fwd.launches
    finally:
        srv.close()
    stats = srv.stats()

    for i, o in enumerate(outs):
        if not (np.isfinite(o.score) and isinstance(o.text, str) and o.tokens.size > 0):
            raise SystemExit(f"request {i}: bad answer {o!r}")
    n_tokens = int(sum(o.tokens.size for o in outs))
    shapes = _expected_launches(gp, rec.calls, cfg.encoder.layers)
    expected = sum(s[2] for s in shapes)
    log(f"  dispatches (B, T, expected B1 launches): {shapes}")
    log(f"  B1 launches in the serving run: {launches} (expected {expected})")
    if launches != expected or any(s[2] < cfg.encoder.layers for s in shapes):
        raise SystemExit("kernel B1 did not run once per encoder layer in every dispatch")
    log(f"  served {stats['requests']} requests in {stats['batches']} batches, "
        f"p50 latency {stats['p50_latency_ms']} ms, {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.1f} tokens/s [{card}]")
    log(f"  sample answer: {outs[0].text[:60]!r} score {outs[0].score:.4f}")

    # served answers equal direct hub.inference on the same batches, and
    # each future got the answer to its own record
    mismatches = 0
    where = {}
    for instruction, data, kw, out in rec.calls:
        direct = hub.inference(instruction, data, **kw)
        batch = data if isinstance(data, list) else [data]
        served = out if isinstance(data, list) else [out]
        direct = direct if isinstance(data, list) else [direct]
        for j, (o, r) in enumerate(zip(served, direct, strict=True)):
            mismatches += not np.array_equal(o.tokens, r.tokens)
            where[id(o)] = batch[j]
    misrouted = sum(where.get(id(o)) != data for o, (data, _) in zip(outs, reqs))
    log(f"  served vs direct hub.inference on the same batches: {mismatches} mismatches, "
        f"{misrouted} answers routed to the wrong request")
    if mismatches or misrouted:
        raise SystemExit("served answers differ from direct inference")

    # encoder output, kernel B1 vs plain attention
    recs = [r for r, _ in reqs[:8]]
    sample = gp.collate([gp(Instruction(TPL, split="test").format(**r)) for r in recs])
    src = slots_to_device([s for s in sample["net_input"]["slots"] if s.is_src], hub.device)
    mode = cfg.attn_kernel
    with torch.no_grad():
        before = dense_attention_fwd.launches
        enc_kernel = model.net.encode(src).x.float()
        used = dense_attention_fwd.launches - before
        cfg.attn_kernel = "xla"
        try:
            enc_plain = model.net.encode(src).x.float()
        finally:
            cfg.attn_kernel = mode
    rel = ((enc_kernel - enc_plain).norm() / enc_plain.norm()).item()
    mx = (enc_kernel - enc_plain).abs().max().item()
    log(f"  encoder output kernel vs plain attention {tuple(enc_kernel.shape)}: "
        f"rel {rel:.3e} (tol {ENC_REL_TOL}), max abs {mx:.3e} (tol {ENC_ABS_TOL}), "
        f"kernel launches {used}")
    if used != cfg.encoder.layers or not rel <= ENC_REL_TOL or not mx <= ENC_ABS_TOL:
        raise SystemExit("encoder output under kernel B1 disagrees with plain attention")
    return {"dense_attention_fwd": launches}


def _report_profile(prof, wall_ms, what, card):
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"profile: {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle {100 * (1 - busy_ms / wall_ms):.1f}%, {n_launch} kernel launches [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")


def phase_profile(hub, card):
    """One dispatch of the serving path (the first 8 requests, beam 5) under
    torch.profiler: wall time, device busy time and idle share, kernel
    launches, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    recs = [r for r, _ in _requests()[:8]]
    _sync(hub.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hub.inference(TPL, recs, max_len_b=MAX_LEN_B)
        _sync(hub.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report_profile(prof, wall_ms, "one dispatch (B=8, beam 5)", card)


# ------------------------------------------------------------- training
_WORDS = ["the", "storm", "moved", "north", "over", "the", "coast", "on", "monday", "and",
          "officials", "said", "that", "schools", "would", "stay", "closed", "for", "two",
          "days", "while", "crews", "repair", "power", "lines", "12", "345", "city"]


def _text(rng, lo, hi):
    n = int(rng.integers(lo, hi + 1))
    s = ""
    while len(s) < n:
        s += rng.choice(_WORDS) + " "
    return s[:n].strip().ljust(n, "x")


def make_train_batches(gp, tasks=None):
    """One collated batch (numpy) per task, from seeded text, through
    Instruction(template, split="train") -> GeneralPreprocess -> collate:
    span masking runs on the text_infilling source."""
    from ofasys_torch.preprocessor.instruction import Instruction

    rng = np.random.default_rng(SEED + 1)
    out = {}
    for name, spec in (tasks or TRAIN_TASKS).items():
        if "text" in spec:
            recs = [{"text": _text(rng, *spec["text"])} for _ in range(spec["batch"])]
        else:
            recs = [{"src": _text(rng, *spec["src"]), "tgt": _text(rng, *spec["tgt"])}
                    for _ in range(spec["batch"])]
        out[name] = gp.collate([gp(Instruction(spec["template"], split="train").format(**r))
                                for r in recs])
    return out


def _task_shapes(batch):
    slots = batch["net_input"]["slots"]
    B, Ts = [s for s in slots if s.is_src][0].value["inputs"].shape
    Tt = [s for s in slots if not s.is_src][-1].value["inputs"].shape[1]
    return B, Ts, Tt


def train_shapes(batches):
    """[(label, (B, Tq, Tk), causal)] of the attention calls of one update:
    encoder self, decoder self (causal, folded into the bias) and cross."""
    shapes = []
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        shapes += [(f"{name}_encoder", (B, Ts, Ts), False),
                   (f"{name}_decoder_causal", (B, Tt, Tt), True),
                   (f"{name}_cross", (B, Tt, Ts), False)]
    return shapes


def _expected_train_launches(batches, cfg):
    """B1 (and B2) launches one update should make: one per attention call
    that meets the dense gate (ofasys_torch.ops.dense_attention.dense_supported,
    as MultiheadAttention asks it)."""
    from ofasys_torch.ops.dense_attention import dense_supported

    H = cfg.encoder.attention_heads
    D = cfg.encoder.embed_dim // H
    n = 0
    for b in batches.values():
        B, Ts, Tt = _task_shapes(b)
        gate = lambda Tq, Tk: int(dense_supported(B, Tq, Tk, D, H, cfg.attention_dropout))
        n += cfg.encoder.layers * gate(Ts, Ts) + cfg.decoder.layers * (gate(Tt, Tt) + gate(Tt, Ts))
    return n


def build_train_model(d, device, arch="base", dtype=torch.bfloat16):
    """The arch at full width with random weights from SEED; dropout keeps
    its default of 0.1, attention dropout its default of 0."""
    from ofasys_torch import GeneralistModel

    t0 = time.perf_counter()
    model = GeneralistModel(arch=arch)
    model.initialize(d, active_adaptors=("text",), dtype=dtype, device=device, seed=SEED)
    cfg = model.cfg
    log(f"train: {arch} arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} dropout={cfg.dropout} built in {time.perf_counter() - t0:.1f} s")
    return model


def _grads(model, crit, params, step, batches):
    """One update's raw-summed gradients over every task (no optimizer)."""
    from ofasys_torch.engine.train_step import make_grad_step

    total = None
    for i, b in enumerate(batches.values()):
        g, _, _ = make_grad_step(model, crit, fold=i)(params, step, b, SEED)
        total = g if total is None else [a + c for a, c in zip(total, g)]
    return total


def train_and_check(model, gp, card, tasks=None, batches=None):
    """Drive the training path: N_UPDATES summed two-task updates through
    make_multitask_train_step, then check what came out. Returns the
    kernel launch counts of that run, the step and the batches."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.criterion import (
        LabelSmoothedCrossEntropyCriterion,
        LabelSmoothedCrossEntropyCriterionConfig,
    )
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
    from ofasys_torch.ops.dense_attention import dense_attention_bwd, dense_attention_fwd
    from ofasys_torch.utils.pytree import sample_to_device

    device, cfg = model.net.device, model.cfg
    batches = batches or make_train_batches(gp, tasks)
    for name, b in batches.items():
        B, Ts, Tt = _task_shapes(b)
        log(f"  task {name}: B={B} encoder T={Ts} decoder T={Tt} target tokens={b['ntokens']}")
    dev = {n: sample_to_device(b, device) for n, b in batches.items()}
    crit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(),
                                              pad_id=model.global_dict.pad())
    opt = build_optimizer(OptimizationConfig(lr=(TRAIN_LR,)))
    state = TrainState.create(model.net, opt)
    step = make_multitask_train_step(model, {n: crit for n in dev}, opt)
    n_samples = sum(b["nsentences"] for b in batches.values())

    # warm-up update (allocator, cuBLAS handles) outside the measured run
    state, _ = step(state, dev, SEED)
    _sync(device)

    dense_attention_fwd.launches = dense_attention_bwd.launches = 0
    outs, times = [], []
    for _ in range(N_UPDATES):
        t0 = time.perf_counter()
        state, out = step(state, dev, SEED)
        _sync(device)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"dense_attention_fwd": dense_attention_fwd.launches,
                "dense_attention_bwd": dense_attention_bwd.launches}

    losses, gnorms = [], []
    for out in outs:
        tasks_out = out["tasks"].values()
        losses.append(sum(float(t["loss"]) for t in tasks_out)
                      / sum(float(t["sample_size"]) for t in tasks_out))
        gnorms.append(float(out["gnorm"]))
    per_task = {n: [round(float(o["tasks"][n]["loss"]) / float(o["tasks"][n]["sample_size"]), 4)
                    for o in outs] for n in dev}
    log(f"  loss per token over the {N_UPDATES} updates: {[round(x, 5) for x in losses]}; "
        f"per task {per_task}; gnorm {[round(x, 4) for x in gnorms]}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise SystemExit("a training loss or gnorm is not finite")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall over {N_UPDATES} updates on repeated batches")
    step_ms = statistics.median(times) * 1e3
    log(f"  step time {step_ms:.2f} ms (median of {N_UPDATES}; all {[round(t * 1e3, 2) for t in times]}), "
        f"{n_samples} samples per update = {n_samples / (step_ms / 1e3):.1f} samples/s [{card}]")

    expected = N_UPDATES * _expected_train_launches(batches, cfg)
    log(f"  launches in the training run: {launches} (expected {expected} each)")
    if device.type == "cuda":
        if any(n != expected for n in launches.values()) or expected == 0:
            raise SystemExit("kernels B1/B2 did not run once per gated attention call")
    else:
        log("  (CPU rehearsal: the plain versions stand in, no launch is counted)")

    # one update's gradients, kernels vs plain attention, dropout 0
    names = [n for n, _ in model.net.named_parameters()]
    saved = cfg.dropout, cfg.attn_kernel
    cfg.dropout = 0.0
    try:
        g_kernel = _grads(model, crit, state.params, state.step, dev)
        cfg.attn_kernel = "xla"
        g_plain = _grads(model, crit, state.params, state.step, dev)
    finally:
        cfg.dropout, cfg.attn_kernel = saved
    diff = torch.sqrt(sum(((a - b).float() ** 2).sum() for a, b in zip(g_kernel, g_plain)))
    ref = torch.sqrt(sum((b.float() ** 2).sum() for b in g_plain))
    kern = torch.sqrt(sum((a.float() ** 2).sum() for a in g_kernel))
    rel = (diff / ref).item()            # bounds the global norm's relative error
    norm_rel = (abs(kern - ref) / ref).item()
    worst, worst_name = 0.0, None
    for name, a, b in zip(names, g_kernel, g_plain):
        path = name.rsplit(".", 2)
        if name.endswith(".bias") and len(path) > 1 and path[-2] in NOISE_MODULES:
            continue
        nb = b.float().norm().item()
        if nb > 0:
            r = ((a - b).float().norm() / nb).item()
            if r > worst:
                worst, worst_name = r, name
    log(f"  gradients of one update, kernels vs plain attention (dropout 0): |g_kernel - g_plain| "
        f"/ |g_plain| {rel:.3e} (tol {GRAD_REL_TOL}), global norm rel err {norm_rel:.3e}, "
        f"worst leaf {worst_name} rel {worst:.3e} (tol {LEAF_REL_TOL}), |g| {ref.item():.4e}")
    if not rel <= GRAD_REL_TOL or not worst <= LEAF_REL_TOL:
        raise SystemExit("gradients under kernels B1/B2 disagree with the plain attention path")
    return launches, dict(step_ms=step_ms, samples_per_s=n_samples / (step_ms / 1e3),
                          losses=losses, grad_rel=rel, grad_norm_rel=norm_rel,
                          grad_worst_leaf=worst), (step, state, dev)


def phase_profile_train(step, state, batches, card):
    """One training update under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches, SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report_profile(prof, wall_ms, "one training update (text_infilling B=128 + gigaword B=64)", card)


def _kernel_entry(name, replaces, launches, rows, err_key, nominal, card, **extra):
    row = next(r for r in rows if r["shape"] == nominal)
    return {
        "name": name,
        "route": "cuda",
        "source": f"ofasys_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches["train"],
        "launches_by_path": launches,
        "max_abs_err": max(r[err_key] for r in rows),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "nominal_shape": nominal,
        "card": card,
        "shapes": rows,
        **extra,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ofasys_torch  # noqa: F401  (fails where the package is absent)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    phase_build()
    hub = build_base_hub()
    train_batches = make_train_batches(hub.general_preprocess)
    fres, bres = phase_kernels(planned_dispatch_shapes(), train_shapes(train_batches))
    serve_counts = serve_and_check(hub, card)
    phase_profile(hub, card)
    model = build_train_model(hub.global_dict, "cuda")
    train_counts, train_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, batches=train_batches)
    phase_profile_train(step, state, dev, card)
    kernels = [
        _kernel_entry("dense_attention_fwd", "ofasys_tpu/ops/pallas_dense_attention.py:87",
                      {"serve": serve_counts["dense_attention_fwd"],
                       "train": train_counts["dense_attention_fwd"]},
                      fres, "err_out", "text_infilling_encoder", card,
                      max_abs_err_lse=max(r["err_lse"] for r in fres)),
        _kernel_entry("dense_attention_bwd", "ofasys_tpu/ops/pallas_dense_attention.py:180",
                      {"train": train_counts["dense_attention_bwd"]},
                      bres, "err", "text_infilling_encoder", card),
    ]
    log(f"train: {json.dumps(train_res)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
