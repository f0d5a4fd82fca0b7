"""Chip smoke test of ofasys_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build: every CUDA kernel of ofasys_torch/csrc, one nvcc each, in parallel
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it, with times (CUDA events, median)
  4. slice: text→text serving at the base arch's full width (E=768, 12 heads,
     6+6 layers) with a 50,000-symbol text vocabulary, random weights from a
     seed: 16 requests through InferenceServer -> OFASys.inference ->
     SequenceGenerator, with the kernel launch counts of that run
  5. profile: one dispatch under torch.profiler (device busy and idle share,
     the kernels that take the most device time)
Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX or ofasys_tpu. Exits non-zero without CUDA.
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


def _dense_inputs(B, Tq, Tk, H, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * 0.125).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16)
    keep = torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.2
    for b in range(1, B):                     # padding-style tails
        keep[b, :, Tk - 3 * b:] = False
    keep[:, :, 0] = True                      # no fully-masked query row
    return q, k, v, bias, keep.to(torch.int8)


def phase_kernels(dispatch_shapes):
    """Kernel B1 at the serving path's encoder shapes (one per planned
    dispatch), the nominal serving shape B=8 T=128, and a ragged cross
    shape; base arch H=12, D=64."""
    import torch.nn.functional as F

    from ofasys_torch.ops.dense_attention import dense_attention_fwd, dense_attention_fwd_reference

    shapes = [(f"dispatch{i} B={B} T={T}", (B, T, T, 12, 64))
              for i, (B, T) in enumerate(dispatch_shapes)]
    shapes += [("serving", (8, 128, 128, 12, 64)), ("cross", (3, 24, 200, 12, 64))]
    results = []
    for label, (B, Tq, Tk, H, D) in shapes:
        q, k, v, bias, mask = _dense_inputs(B, Tq, Tk, H, D, SEED)
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
        # the same function as one library call: additive float bias with the
        # mask folded in as -1e9, q already scaled
        add = (bias[None].float() + torch.where(mask[:, :, None, :] != 0, 0.0, -1e9)).to(torch.bfloat16)
        q4, k4, v4 = (t.view(t.shape[0], t.shape[1], H, D).transpose(1, 2) for t in (q, k, v))
        kernel_ms = time_ms(lambda: dense_attention_fwd(q, k, v, bias, mask, H))
        plain_ms = time_ms(lambda: dense_attention_fwd_reference(q, k, v, bias, mask, H))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0))
        n_bytes = 2 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + H * Tq * Tk) + B * Tk + 4 * B * H * Tq
        flops = 4 * B * H * Tq * Tk * D
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library (scaled_dot_product_attention) {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({n_bytes} B, {flops} FLOP)")
        results.append(dict(shape=label, err_out=err_out, err_lse=err_lse, kernel_ms=kernel_ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by="bytes" if t_bytes >= t_ops else "operations"))
    return results


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"profile: one dispatch (B=8, beam 5): wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle {100 * (1 - busy_ms / wall_ms):.1f}%, {n_launch} kernel launches [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")


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
    kres = phase_kernels(planned_dispatch_shapes())
    hub = build_base_hub()
    counts = serve_and_check(hub, card)
    phase_profile(hub, card)
    kernels = [{
        "name": "dense_attention_fwd",
        "route": "cuda",
        "source": "ofasys_torch/csrc/dense_attention_fwd.cu",
        "replaces": "ofasys_tpu/ops/pallas_dense_attention.py:87",
        "tpu_kernel": "ops/pallas_dense_attention.py:_fwd_kernel",
        "launches": counts["dense_attention_fwd"],
        "max_abs_err": max(r["err_out"] for r in kres),
        "max_abs_err_out": max(r["err_out"] for r in kres),
        "max_abs_err_lse": max(r["err_lse"] for r in kres),
        "ms": kres[0]["kernel_ms"],
        "kernel_ms": kres[0]["kernel_ms"],
        "plain_ms": kres[0]["plain_ms"],
        "bound_ms": kres[0]["bound_ms"],
        "bound_by": kres[0]["bound_by"],
        "library_ms": kres[0]["library_ms"],
        "card": card,
        "shapes": kres,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
