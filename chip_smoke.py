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
  8. serve_long: the text lengths raised to 1,000 (a second hub on the same
     model): 16 summarization requests with sources of 600-960 bytes
     (encoder T up to about 1,000), kernel B3 in every dispatch's encoder
  9. serve_truncated: one dispatch of 8 requests under the default
     max_src_length = 256 with 300-400 byte sources, cut to 257 tokens
 10. train_long: 5 summed two-task updates at long lengths
     (text_infilling_long B=16 with documents of 480-520 bytes,
     gigaword_long B=16 with articles of 880-960 bytes): kernel B3 and the
     one backward pass (B4-dq, B4-dkv, B5) on every long attention, B1/B2
     on the short decoder, a falling loss and one update's gradients
     against the plain attention path (4 samples per task), also with the
     flash backward's dd taken from the unrounded output
 11. profile_long: one long update under torch.profiler
 12. serve_int8: the serve phase's 16 requests on a deep copy of the serve
     model after ``OFASys.quantize()`` (w8a8): kernel B7 on every
     projection and the tied logits, 48 + 49 S launches per dispatch of S
     decode steps, tokens equal to the same hub with B7's plain version,
     parameter bytes before and after, one dispatch profiled
 13. serve_ln: one dispatch of the serve mix on a second model from the
     same seed with ln_impl='pallas' (kernel B6-fwd, 25 + 37 S launches per
     dispatch), first-step logits against ln_impl='xla'
 14. train_ln: the train phase's 5 updates with ln_impl='pallas' (124
     B6-fwd and 124 B6-bwd per update), gradients against ln_impl='xla';
     then one ln_impl='hybrid' update (124 B6-bwd, no B6-fwd)
 15. serve_caption: image→text serving on the same model (adaptors text +
     image_vit): 16 requests of "[IMAGE:img] what does the image describe?
     -> [TEXT:cap]" with 224 x 224 images from a seeded generator (12 beam
     5, 4 greedy), kernel B1 in every dispatch's encoder (196 patches + the
     prompt's tokens), p50 and tokens/s beside serve's
 16. train_mm: 5 summed three-task updates (caption B=64 with 224 x 224
     images, text_infilling B=128, vqa B=48 with an image and a question):
     B1 and B2 once per attention call, a falling loss, one update's
     gradients against the plain attention path; one update profiled
 17. train_rowmajor: the same three-task step with OFASYS_DENSE_BWD=rowmajor
     set for the phase and restored after: kernel B2r once per dense
     attention and B2 not at all, one update's gradients against the plain
     attention path and against B2's from the same weights and batches
     (GRAD_FROB_TOL), the step time beside train_mm's
The kernel phase also holds kernel B3 and the one flash backward pass (for
B4-dq, B4-dkv and B5) against their plain versions at every shape of the
long paths, a per-(b, h) bias, a causal and a ragged shape and at
FLASH_EDGE_SHAPES (head dims 88, 128 and 256, a batch of one, ragged Tq !=
Tk, T = 4,096 past the backward's scratch cap), each run twice for equal
bits and with planted faults (a key tile left out; for the backward also
dd = 0) at every shape; B7 at serve_int8's shapes (decode logits, fc1, fc2
and q/k/v/out at 40 and 4 rows, the encoder's projections, a ragged K for
the __dp4a kernel), bit for bit, each with its plan and a planted fault (a
K slice left out: one cluster rank's share under a split); B6 at the train
mix's shapes and at E = 1,024, 4,096 and an odd 1,001; B2r beside B2 at
every training shape and at EDGE_SHAPES (ragged Tq != Tk, B=1, head dims
88, 128 and 256), B2 and B2r each run
twice for equal bits and with a planted key-tile fault, and B1 and B2r (and
B2) with the scale and the causal mask inside the kernel at a decoder shape
and at a shape with Tq < Tk (the causal offset), with two planted faults.
The build phase logs ptxas's registers and spills of every kernel.
Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
Imports nothing of JAX or ofasys_tpu. Exits non-zero without CUDA.

The serve and train phases can be rehearsed on the CPU at a tiny arch,
where the kernels' plain versions stand in and no launch is counted:
``train_and_check(build_train_model(d, "cpu", arch="tiny"), gp, "cpu",
tasks=TINY_TRAIN_TASKS)``; the long paths the same way with
``long_preprocess(d)``, ``TINY_LONG_TRAIN_TASKS`` and
``ofasys_torch.model.transformer.flash_available`` patched to return True
(see the README); serve_int8 and serve_ln with
``serve_int8_and_check(hub, "cpu")`` and ``serve_ln_and_check(hub, "cpu")``,
train_ln with ``train_ln_and_check(d, gp, "cpu", arch="tiny",
tasks=TINY_TRAIN_TASKS)``; the image phases with a ``GeneralPreprocess(d,
active=["text", "image"])``: ``serve_caption_and_check(hub, "cpu")``,
``train_and_check(m, gp, "cpu", tasks=TINY_MM_TRAIN_TASKS, label="train_mm")``
and ``train_rowmajor_and_check(d, gp, "cpu", arch="tiny",
tasks=TINY_MM_TRAIN_TASKS)``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# FLOP/s, int8 OP/s (tensor cores), fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12

SEED = 0
TPL = "[TEXT:src] -> [TEXT:tgt]"
SERVE_SRC = (40, 200)         # source bytes of the serving run
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
# the long paths (sources and targets past 256 tokens: kernel B3 and the
# one flash backward pass for B4 and B5):
# the text preprocessor's max_src_length and max_tgt_length raised to 1,000
# (examples/long_context.yaml), so every sequence with bos and eos fits the
# base arch's 1,024 positions
LONG = 1000
LONG_SRC = (600, 960)         # serve_long sources: encoder T of about 640-1,000
TRUNC_SRC = (300, 400)        # serve_truncated: cut to 257 tokens at the default 256
LONG_TRAIN_TASKS = {
    "text_infilling_long": dict(template=INFILL_TPL, batch=16, text=(480, 520)),
    "gigaword_long": dict(template=SUMMARY_TPL, batch=16, src=(880, 960), tgt=(40, 60)),
}
TINY_LONG_TRAIN_TASKS = {n: dict(spec, batch=2) for n, spec in LONG_TRAIN_TASKS.items()}
# samples per task of the long gradient check: the plain path it compares
# with keeps (B, H, T, T) scores per layer for the backward
GRAD_CHECK_BATCH = 4
# Kernels B3-B5 vs their plain versions (bf16): B3 out atol 2e-2 (bf16
# output; p is rounded to bf16 against its tile's running max in the
# kernel, the row max in the plain version) and lse atol 1e-3 (fp32 sums in
# another order).
# Backward kernels B2 and the flash backward (B4, B5): each gradient is
# held to the reference's own size, |got - ref|_F / |ref|_F and
# max|got - ref| / max|ref|. dq, dk,
# dv are bf16 outputs that both sides round at the same points (p and ds
# to bf16 before their products), so they differ only where a reordered
# fp32 sum crosses a rounding boundary: Frobenius 1e-3, max 1e-2 (2.5 bf16
# ulps of the largest entry). B2's dbias, B5's and the per-(b, h) ds are
# fp32 sums of unrounded ds: 1e-3 on both measures. At the long shapes
# (rms of dq, dk, dv 0.013-0.25, largest entries 0.65-6.8) a kernel that
# dropped dd is off by 8e-2 or more and one that skipped a key tile by 0.26
# or more (Frobenius): check_flash plants both faults at every training
# and edge shape and fails unless the limits catch them.
GRAD_FROB_TOL = 1e-3
GRAD_MAX_TOL = 1e-2
DS_REL_ATOL = 1e-3
FLASH_TIMING = dict(n=5, repeats=3)   # flash calls take milliseconds: fewer repeats

# the image slice: ofasys_tpu's caption template (task/tasks.py:78, the hub's
# first example) and the VQA template (task/tasks.py:485), 224 x 224 images
# (196 patches of 16 pixels); batch sizes and lengths follow bench.py's
# caption (B=64, target about 24) and grounding/VQA (B=48, question about
# 16, answer about 8) tasks
ACTIVE_ADAPTORS = ("text", "image_vit")
CAPTION_TPL = "[IMAGE:img] what does the image describe? -> [TEXT:cap]"
VQA_TPL = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
IMAGE_SIZE = 224
MM_TRAIN_TASKS = {
    "caption": dict(template=CAPTION_TPL, batch=64, image=IMAGE_SIZE, cap=(20, 24)),
    "text_infilling": TRAIN_TASKS["text_infilling"],
    "vqa": dict(template=VQA_TPL, batch=48, image=IMAGE_SIZE, question=(14, 16), answer=(6, 8)),
}
TINY_MM_TRAIN_TASKS = {
    "caption": dict(MM_TRAIN_TASKS["caption"], batch=4),
    "text_infilling": TINY_TRAIN_TASKS["text_infilling"],
    "vqa": dict(MM_TRAIN_TASKS["vqa"], batch=2),
}
# B1 and B2r with the scale and the causal mask inside the kernel, as a
# direct ``_dense_attention(..., scale, causal=True, H)`` call runs them:
# the caption decoder's shape and one with Tq < Tk (the causal offset)
INSIDE_SHAPES = [("caption_decoder_inside", (64, 32, 32)), ("causal_offset_inside", (5, 40, 72))]
INSIDE_SCALE = 0.125          # (2 * D) ** -0.5 at D = 32; exact in bf16
# the kernel phase's shapes beyond the paths' own (B, Tq, Tk, H, D): ragged
# Tq != Tk, a batch of one, the image tasks' nominal 196 patches, and head
# dims where the tensor-core kernels pad D (88, the 10b arch's) or split
# B2's keys into ranges (128 at Tk = 256, 256), with H * D <= 4096
EDGE_SHAPES = [("ragged_cross", (3, 24, 200, 12, 64), False), ("ragged_40_200", (3, 40, 200, 12, 64), False),
               ("B1", (1, 64, 64, 12, 64), False), ("patches_196", (64, 196, 196, 12, 64), False),
               ("D88", (8, 96, 96, 32, 88), False), ("D128_T256", (4, 256, 256, 8, 128), False),
               ("D256", (4, 64, 100, 16, 256), False)]
# the flash kernels' shapes beyond the long paths' own (B, Tq, Tk, H, D),
# causal: head dims where the tensor-core kernels pad D (88) or take their
# other tiles (B3: 128; 256 with 32-key tiles; the backward: 112-, 112- and
# 48-key ranges), with H * D <= 4096, a batch of one at T = 1,000 (the
# backward's per-(b, h) ds), ragged Tq != Tk with Tk no multiple of the
# 64-key tile, and T = 4,096, where the backward's dq partials (18 ranges)
# pass fl.SCRATCH_CAP and its samples go one at a time
FLASH_EDGE_SHAPES = [("flash_D88", (2, 300, 333, 32, 88), False),
                     ("flash_D128", (4, 300, 300, 16, 128), False),
                     ("flash_D256_causal", (2, 290, 290, 16, 256), True),
                     ("flash_B1", (1, 1000, 1000, 12, 64), False),
                     ("flash_ragged", (3, 200, 333, 12, 64), False),
                     ("flash_long_T4096", (2, 4096, 4096, 12, 64), False)]

N_UPDATES = 5
TRAIN_LR = 1e-4
# One update's gradients (dropout 0) under the kernels vs the plain
# attention path differ by bf16 rounding carried through 12 layers forward
# and back (the flash route also rounds the bias and its gradient to bf16):
# the position leaves by up to 4e-2 even between the plain path with bf16
# and with fp32 scores. The worst leaf (0.148) is the flash dd below. The
# key-side biases (k_proj, pos_k_linear, cross_pos_k_linear) shift every
# score of a softmax row alike: their gradient is 0 in exact arithmetic and
# rounding noise on both paths, so the per-leaf check leaves them out.
GRAD_REL_TOL = 5e-2
LEAF_REL_TOL = 0.25
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")
# the plain path's score dtype (attn_logits) for the gradient comparison:
# both are computed and logged, the check reads GRAD_REF_LOGITS (fp32
# scores, as the kernels keep them)
GRAD_PLAIN_LOGITS = ("compute", "fp32")
GRAD_REF_LOGITS = "fp32"
# The flash backward takes dd = rowsum(do * o) from the bf16 output o, as
# ofasys_tpu's _flash_backward does, where the plain path's softmax
# backward sums p * dp exactly: per row, ds then sums to a small nonzero
# amount that dq carries along the mean key. Leaves that sum dq over every
# query row (a cross attention's q_proj.bias, the LayerNorm before it) are
# off by up to 0.15 on the long path. With dd from the unrounded output
# (_dd_from_unrounded_output) every leaf must agree within DD_LEAF_TOL.
DD_LEAF_TOL = 5e-2
# Kernel B6 vs its plain version (same inputs on the card): y (bf16) within
# one bf16 ulp, |y - ref| <= 2^-7 |ref| + 1e-3 (a reordered fp32 row sum can
# move the value before rounding across a rounding boundary); mu and rstd
# rtol 1e-5; dx (bf16) as GRAD_FROB_TOL / GRAD_MAX_TOL; dg and db, fp32 sums
# over up to 12,288 rows in another order, LN_SUM_TOL on both measures. A dg
# that skipped one row is off by about 1/sqrt(N) (Frobenius), 9e-3 at
# N = 12,288: the planted fault must fail LN_SUM_TOL.
LN_SUM_TOL = 1e-4
# serve_ln: first-step logits under B6 (fast-variance stats) vs the default
# LayerNorm (two-pass variance): both fp32 stats of the same bf16 inputs, so
# only single bf16 roundings differ, carried through 12 layers as in
# ENC_REL_TOL: relative Frobenius error <= LN_LOGIT_REL_TOL.
LN_LOGIT_REL_TOL = 2e-2


# every CUDA kernel of the port: the TPU kernel it replaces and its source
KERNELS = {
    "dense_attention_fwd": ("ofasys_tpu/ops/pallas_dense_attention.py:87",
                            "ofasys_torch/csrc/dense_attention_fwd.cu"),
    "dense_attention_bwd": ("ofasys_tpu/ops/pallas_dense_attention.py:180",
                            "ofasys_torch/csrc/dense_attention_bwd.cu"),
    "dense_attention_bwd_rowmajor": ("ofasys_tpu/ops/pallas_dense_attention.py:116",
                                     "ofasys_torch/csrc/dense_attention_bwd_rowmajor.cu"),
    "flash_attention_fwd": ("ofasys_tpu/ops/pallas_attention.py:58",
                            "ofasys_torch/csrc/flash_attention_fwd.cu"),
    "flash_attention_bwd": ("ofasys_tpu/ops/pallas_attention.py:341",
                            "ofasys_torch/csrc/flash_attention_bwd.cu"),
    "int8_matmul_fwd": ("ofasys_tpu/ops/pallas_int8.py:44", "ofasys_torch/csrc/int8_matmul.cu"),
    "layer_norm_fwd": ("ofasys_tpu/ops/pallas_layernorm.py:45", "ofasys_torch/csrc/layer_norm.cu"),
    "layer_norm_bwd": ("ofasys_tpu/ops/pallas_layernorm.py:59", "ofasys_torch/csrc/layer_norm.cu"),
}
# the three TPU kernels of the flash backward, each replaced by the one pass
# flash_attention_bwd: one row each in the kernels line, with the error of
# its part of the gradients
FLASH_BWD_ROWS = {
    "flash_attention_bwd_dq": ("ofasys_tpu/ops/pallas_attention.py:341", "err_dq"),
    "flash_attention_bwd_dkv": ("ofasys_tpu/ops/pallas_attention.py:404", "err_dkv"),
    "flash_attention_bwd_dbias": ("ofasys_tpu/ops/pallas_attention.py:466", "err_dbias"),
}
# the device kernels of B7 (csrc/int8_matmul.cu), by name in a profile
B7_KERNEL_NAMES = ("int8_mma_kernel", "int8_dp4a_kernel")
# the module of each kernel's wrapper, under ofasys_torch.ops
_WRAPPER_MODULE = {"dense": "dense_attention", "flash": "flash_attention", "int8": "int8_matmul",
                   "layer": "layer_norm"}


def log(msg: str):
    print(msg, flush=True)


def _wrappers():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"ofasys_torch.ops.{_WRAPPER_MODULE[name.split('_')[0]]}"), name) for name in KERNELS}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _route(cfg, B, Tq, Tk, dropout_rate=0.0):
    """Which attention the model runs on the card for a text-path call of
    this shape (a bias shared by the batch, a padding mask): 'flash'
    (B3-B5), 'dense' (B1/B2) or 'plain', by MultiheadAttention's own rule."""
    from ofasys_torch.model.transformer import attention_route

    H = cfg.encoder.attention_heads
    return attention_route(cfg, "cuda", B, Tq, Tk, H, cfg.encoder.embed_dim // H, dropout_rate,
                           bias_shape=(1, H, Tq, Tk), mask_shape=(B, 1, 1, Tk))


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


def _dense_inputs(B, Tq, Tk, H, D, seed, causal=False, fold=True):
    """bf16 q (pre-scaled by 0.125), k, v, do, a bf16 bias and an int8
    keep-mask. ``causal`` is folded into the bias as the public wrapper does
    it, or, with ``fold=False``, left to the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * 0.125).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g)
    if causal and fold:                       # folded into the bias, as the wrapper does
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
    written once) and FLOPs (five (Tq, Tk, D) products per head: q.k, do.v,
    ds.k, ds.q, p.do; 10 B Tq Tk E) of kernel B2."""
    E = H * D
    n_bytes = 2 * (2 * B * Tq * E + 2 * B * Tk * E) + 2 * (B * Tq * E + 2 * B * Tk * E) \
        + 4 * B * H * Tq + B * Tk + (2 + 4) * H * Tq * Tk * with_bias
    return n_bytes, 10 * B * Tq * Tk * E


def _bound(n_bytes, ops, peak_ops=PEAK_BF16_FLOPS):
    """The least time in ms: the larger of the bytes over the memory rate
    and the operations over ``peak_ops``, and which of the two it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
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
    """Kernels B2 and B2r against their plain version at one shape as the
    model's path gives it (scale 1, causal folded into the bias), with their
    times side by side. Returns (B2's row, B2r's row)."""
    from ofasys_torch.ops.dense_attention import (
        dense_attention_bwd,
        dense_attention_bwd_reference,
        dense_attention_bwd_rowmajor,
        dense_attention_fwd,
    )

    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, do = _dense_inputs(B, Tq, Tk, H, D, SEED, causal)
    _, lse = dense_attention_fwd(q, k, v, bias, mask, H)
    kernels = {
        "dense_attention_bwd": lambda: dense_attention_bwd(q, k, v, do, lse, bias, mask, H),
        "dense_attention_bwd_rowmajor": lambda: dense_attention_bwd_rowmajor(
            q, k, v, do, lse, bias, mask, H, 1.0, False),
    }
    ref = dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H)
    errs = {}
    for name, fn in kernels.items():
        got = fn()
        torch.cuda.synchronize()
        errs[name], ok = grad_errors(got, ref, False)
        same = all(torch.equal(a, b) for a, b in zip(got, fn()))
        log(f"kernel {name} [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}]: "
            f"{_grad_report(errs[name])}, the same bits twice: {same} -> "
            f"{'ok' if ok and same else 'FAIL'}")
        if not ok or not same:
            raise SystemExit(f"{name} disagrees with its plain version at {label}")
    # planted fault: each kernel with one key tile's p and dS left out
    # (those keys masked, the lse of the full forward kept) must fail the
    # limits on dq, dk, dv and dbias
    lo, hi = min(64, Tk // 2), min(128, Tk)
    hidden = mask.clone()
    hidden[:, :, lo:hi] = 0
    for name, fn in (("B2", dense_attention_bwd), ("B2r", dense_attention_bwd_rowmajor)):
        extra = () if name == "B2" else (1.0, False)
        ferrs, _ = grad_errors(fn(q, k, v, do, lse, bias, hidden, H, *extra), ref, False)
        caught = [n for n, e in ferrs.items() if not e["ok"]]
        log(f"  planted fault {name} with keys {lo}-{hi - 1} left out: "
            + " ".join(f"{n} frob {e['frob']:.2e} max {e['max_rel']:.2e}" for n, e in ferrs.items())
            + f" -> fails the limits for {caught} of {list(ferrs)}")
        if caught != list(ferrs):
            raise SystemExit(f"{label}: the gradient limits pass {name} with a key tile left out")
    q4, k4, v4, add = _sdpa_args(q, k, v, bias, mask, H, D, grad=True)
    do4 = do.view(B, Tq, H, D).transpose(1, 2)
    kernel_ms = {name: time_ms(fn, n=20) for name, fn in kernels.items()}
    plain_ms = time_ms(lambda: dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H), n=20)
    library_ms = _sdpa_bwd_ms(q4, k4, v4, add, do4)
    n_bytes, flops = _bwd_bound(B, Tq, Tk, H, D)
    bound_ms, bound_by = _bound(n_bytes, flops)
    lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"  times [{label}]: B2 {kernel_ms['dense_attention_bwd']:.4f} ms, B2r "
        f"{kernel_ms['dense_attention_bwd_rowmajor']:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention backward) {lib}, bound {bound_ms:.5f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return tuple(dict(shape=label, B=B, Tq=Tq, Tk=Tk, err=max(e["max"] for e in errs[name].values()),
                      errs={n: e["max"] for n, e in errs[name].items()},
                      kernel_ms=kernel_ms[name], plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by) for name in kernels)


def check_inside(label, shape):
    """Kernels B1, B2r and B2 with the scale inside, and B1 and B2r with the
    causal mask inside too (``j <= i + Tk - Tq``), as a direct
    ``_dense_attention(q, k, v, bias, mask, scale, True, H)`` call runs them:
    q unscaled, the bias without the causal fold. Each against its plain
    version, and the causal pair timed beside the folded form of the same
    function. Two planted faults must fail the limits: the causal offset
    dropped (keys ``j <= i`` visible instead), and the scale left out of dq.
    Returns (B1's row, B2r's row)."""
    from ofasys_torch.ops import dense_attention as da

    B, Tq, Tk, H, D = shape
    scale = INSIDE_SCALE
    q, k, v, bias, mask, do = _dense_inputs(B, Tq, Tk, H, D, SEED + 4, causal=True, fold=False)
    q_raw = (q.float() / scale).to(torch.bfloat16)        # exact: a power of two
    tag = f"[{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D} scale={scale} causal inside]"
    out, lse = da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = da.dense_attention_fwd_reference(q_raw, k, v, bias, mask, H, scale, True)
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    log(f"kernel dense_attention_fwd {tag}: max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) "
        f"max|lse-plain|={err_lse:.3e} (atol {LSE_ATOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_fwd with scale and causal inside disagrees at {label}")
    got = da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    torch.cuda.synchronize()
    ref = da.dense_attention_bwd_rowmajor_reference(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    errs, ok = grad_errors(got, ref, False)
    log(f"kernel dense_attention_bwd_rowmajor {tag}: {_grad_report(errs)} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"dense_attention_bwd_rowmajor with scale and causal inside disagrees at {label}")
    again = da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse, bias, mask, H, scale, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"dense_attention_bwd_rowmajor: two runs differ at {label}")
    # the entry itself: autograd through _dense_attention(causal=True) runs B1
    # and B2r (not B2) and hands back the same gradients, dbias in the bias's bf16
    leaves = [t.clone().requires_grad_() for t in (q_raw, k, v, bias)]
    before = da.dense_attention_bwd.launches, da.dense_attention_bwd_rowmajor.launches
    da._dense_attention(*leaves[:3], leaves[3], mask, scale, True, H).backward(do)
    torch.cuda.synchronize()
    ran = (da.dense_attention_bwd.launches - before[0],
           da.dense_attention_bwd_rowmajor.launches - before[1])
    same = all(torch.equal(t.grad, g.to(t.dtype)) for t, g in zip(leaves, got))
    log(f"  _dense_attention(scale={scale}, causal=True) {tag}: backward launches (B2, B2r) {ran}, "
        f"gradients equal to the direct B2r call: {same}")
    if ran != (0, 1) or not same:
        raise SystemExit(f"_dense_attention(causal=True) did not take B2r at {label}")

    # the scale inside B2 and B2r without causal (a non-causal _dense_attention call)
    _, lse_nc = da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale)
    ref_nc = da.dense_attention_bwd_reference(q_raw, k, v, do, lse_nc, bias, mask, H, scale=scale)
    for name, g in (("dense_attention_bwd", da.dense_attention_bwd(
            q_raw, k, v, do, lse_nc, bias, mask, H, scale=scale)),
                    ("dense_attention_bwd_rowmajor", da.dense_attention_bwd_rowmajor(
                        q_raw, k, v, do, lse_nc, bias, mask, H, scale, False))):
        e, ok = grad_errors(g, ref_nc, False)
        log(f"kernel {name} [{label} scale={scale} inside, not causal]: {_grad_report(e)} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} with the scale inside disagrees with its plain version at {label}")

    # planted faults: the same kernel on wrong inputs must fail the limits
    wrong = torch.ones(Tq, Tk, device="cuda").tril().bool()          # j <= i: the offset dropped
    folded = torch.where(wrong, bias.float(), torch.full((), -1e9, device="cuda")).to(torch.bfloat16)
    faults = {}
    if Tk != Tq:
        _, lse_w = da.dense_attention_fwd(q_raw, k, v, folded, mask, H, scale)
        faults["causal offset dropped"] = (
            da.dense_attention_bwd_rowmajor(q_raw, k, v, do, lse_w, folded, mask, H, scale, False),
            ("dq", "dk", "dv", "dbias"))
    # a pre-scaled q with scale 1 gives the same scores and the dq of a
    # kernel that forgot the scale: round(ds) k instead of round(ds * scale) k
    faults["scale left out of dq"] = (
        da.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, 1.0, True), ("dq",))
    for fault, (fgot, moved) in faults.items():
        ferrs, _ = grad_errors(fgot, ref, False)
        caught = [n for n in moved if not ferrs[n]["ok"]]
        log(f"  planted fault {fault}: "
            + " ".join(f"{n} frob {ferrs[n]['frob']:.2e} max {ferrs[n]['max_rel']:.2e}" for n in moved)
            + f" -> fails the limits for {caught} of {list(moved)}")
        if caught != list(moved):
            raise SystemExit(f"{label}: the gradient limits pass a kernel with {fault}")

    # times: inside (tiles above the diagonal skipped) beside the folded form
    fb = torch.where(torch.ones(Tq, Tk, device="cuda").tril(Tk - Tq).bool(), bias.float(),
                     torch.full((), -1e9, device="cuda")).to(torch.bfloat16)
    _, lse_f = da.dense_attention_fwd(q, k, v, fb, mask, H)
    fwd_ms = time_ms(lambda: da.dense_attention_fwd(q_raw, k, v, bias, mask, H, scale, True))
    fwd_folded_ms = time_ms(lambda: da.dense_attention_fwd(q, k, v, fb, mask, H))
    fwd_plain_ms = time_ms(lambda: da.dense_attention_fwd_reference(q_raw, k, v, bias, mask, H, scale, True))
    bwd_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor(
        q_raw, k, v, do, lse, bias, mask, H, scale, True), n=20)
    bwd_folded_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor(
        q, k, v, do, lse_f, fb, mask, H, 1.0, False), n=20)
    b2_folded_ms = time_ms(lambda: da.dense_attention_bwd(q, k, v, do, lse_f, fb, mask, H), n=20)
    bwd_plain_ms = time_ms(lambda: da.dense_attention_bwd_rowmajor_reference(
        q_raw, k, v, do, lse, bias, mask, H, scale, True), n=20)
    import torch.nn.functional as F

    q4, k4, v4, add = _sdpa_args(q, k, v, fb, mask, H, D, grad=True)
    with torch.no_grad():
        fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=1.0))
    bwd_lib_ms = _sdpa_bwd_ms(q4, k4, v4, add, do.view(B, Tq, H, D).transpose(1, 2))
    fb_ms, fb_by = _bound(*_fwd_bound(B, Tq, Tk, H, D))
    bb_ms, bb_by = _bound(*_bwd_bound(B, Tq, Tk, H, D))
    lib = "not timed" if bwd_lib_ms is None else f"{bwd_lib_ms:.4f} ms"
    log(f"  times {tag}: B1 {fwd_ms:.4f} ms (causal folded into the bias {fwd_folded_ms:.4f}, plain "
        f"{fwd_plain_ms:.4f}, library {fwd_lib_ms:.4f}, bound {fb_ms:.5f}); B2r {bwd_ms:.4f} ms "
        f"(folded {bwd_folded_ms:.4f}, B2 folded {b2_folded_ms:.4f}, plain {bwd_plain_ms:.4f}, "
        f"library {lib}, bound {bb_ms:.5f})")
    common = dict(shape=label, B=B, Tq=Tq, Tk=Tk, scale=scale, causal_inside=True)
    return (dict(common, err_out=err_out, err_lse=err_lse, kernel_ms=fwd_ms, folded_ms=fwd_folded_ms,
                 plain_ms=fwd_plain_ms, library_ms=fwd_lib_ms, bound_ms=fb_ms, bound_by=fb_by),
            dict(common, err=max(e["max"] for e in errs.values()),
                 errs={n: e["max"] for n, e in errs.items()}, kernel_ms=bwd_ms,
                 folded_ms=bwd_folded_ms, b2_folded_ms=b2_folded_ms, plain_ms=bwd_plain_ms,
                 library_ms=bwd_lib_ms, bound_ms=bb_ms, bound_by=bb_by))


def phase_kernels(dispatch_shapes, train_shapes):
    """Kernel B1 at the serving paths' encoder shapes (``dispatch_shapes``:
    [(label, (B, T))], one per planned dispatch), the nominal serving shape
    B=8 T=128 and every training shape; kernels B2 and B2r at every training
    shape (B2 also the same bits twice, and with a key tile left out, which
    the limits must catch); all three at EDGE_SHAPES; B1 and B2r with the
    scale and the causal mask inside at INSIDE_SHAPES. The paths' shapes are
    at the base arch, H=12, D=64. ``train_shapes`` is [(label, (B, Tq, Tk),
    causal)]. Returns the rows of B1, B2 and B2r."""
    fwd, bwd, row = [], [], []
    for label, (B, T) in dispatch_shapes:
        fwd.append(check_fwd(label, (B, T, T, 12, 64)))
    fwd.append(check_fwd("serving", (8, 128, 128, 12, 64)))
    calls = [(label, (B, Tq, Tk, 12, 64), causal) for label, (B, Tq, Tk), causal in train_shapes]
    for label, shape, causal in calls + EDGE_SHAPES:
        fwd.append(check_fwd(label, shape, causal))
        b2, b2r = check_bwd(label, shape, causal)
        bwd.append(b2)
        row.append(b2r)
    for label, (B, Tq, Tk) in INSIDE_SHAPES:
        f, r = check_inside(label, (B, Tq, Tk, 12, 64))
        fwd.append(f)
        row.append(r)
    return fwd, bwd, row


def _flash_inputs(B, Tq, Tk, H, D, seed, per_bh=False):
    """bf16 q, k, v, do (B, T, H*D) as the projections give them, a bias
    (H, Tq, Tk) shared by the batch or (B*H, Tq, Tk), and an int8 keep-mask
    (B, 1, Tk) with padding-style tails that keeps key 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H * D, device="cuda", generator=g).to(torch.bfloat16)
                   for T in (Tq, Tk, Tk, Tq))
    bias = torch.randn(B * H if per_bh else H, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16)
    keep = torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.2
    for b in range(1, B):
        keep[b, :, max(1, Tk - 7 * b):] = False
    keep[:, :, 0] = True
    return q, k, v, bias, keep.to(torch.int8), do


def _flash_bounds(B, Tq, Tk, H, D, nb, causal):
    """(bytes, FLOP) of kernel B3 and of the whole backward (the one pass of
    B4-dq, B4-dkv and B5) at one shape: each input read once, each output
    written once (the bias gradient in full: (H, Tq, Tk) for a shared bias,
    ds (B H, Tq, Tk) for one per (b, h)); FLOP 2 B H Tq Tk D for each (Tq,
    Tk, D) product the function needs: B3 two (q.k, p.v), the backward five
    (q.k, do.v, p.do, ds.q, ds.k). Causal skips the tiles above the
    diagonal: half the FLOP and half the bias read."""
    E = H * D
    frac = 0.5 if causal else 1.0
    bias = int(2 * nb * Tq * Tk * frac)
    qkv = 2 * (B * Tq * E + 2 * B * Tk * E)
    core = B * H * Tq * Tk * D * frac
    reads = qkv + 2 * B * Tq * E + 8 * B * H * Tq + bias + B * Tk      # q, k, v, do, lse, dd
    writes = 2 * (B * Tq * E + 2 * B * Tk * E) + 4 * nb * Tq * Tk      # dq, dk, dv, bias gradient
    return {
        "flash_attention_fwd": (qkv + bias + B * Tk + 2 * B * Tq * E + 4 * B * H * Tq, int(4 * core)),
        "flash_attention_bwd": (reads + writes, int(10 * core)),
    }


def _flash_sdpa(q, k, v, bias, mask, H, D, causal, grad=False):
    """The same function for one library call: (B, H, T, D) views and an
    additive bf16 mask = bias + (-1e9 on masked keys and above the causal
    diagonal). With ``grad`` the bias is a (1|B, H, Tq, Tk) leaf that needs
    its gradient and the sum is taken inside the timed call."""
    B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]
    neg = torch.where(mask[:, :, None, :] != 0, 0.0, -1e9)
    if causal:
        neg = neg + torch.where(torch.ones(Tq, Tk, device="cuda").tril().bool(), 0.0, -1e9)
    neg = neg.to(torch.bfloat16)
    b4 = bias.view(-1, H, Tq, Tk)
    q4, k4, v4 = (t.view(B, t.shape[1], H, D).transpose(1, 2) for t in (q, k, v))
    if grad:
        q4, k4, v4, b4 = (t.detach().clone().requires_grad_() for t in (q4, k4, v4, b4))
        return q4, k4, v4, b4, neg
    return q4, k4, v4, (b4 + neg).to(torch.bfloat16)


def _flash_sdpa_bwd_ms(q4, k4, v4, b4, neg, do4, scale):
    """The library yardstick of B4 + B5: autograd through
    scaled_dot_product_attention with the bias needing its gradient, minus
    the forward."""
    import torch.nn.functional as F

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4 + neg, scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q4, k4, v4, b4), do4)

    try:
        both = time_ms(fwd_bwd, **FLASH_TIMING)
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library backward not timed: {str(e).splitlines()[0][:120]}")
        return None
    with torch.no_grad():
        return both - time_ms(fwd, **FLASH_TIMING)


def grad_errors(got, ref, per_bh):
    """dq, dk, dv and the bias gradient (ds for a per-(b, h) bias) against
    the plain version's: max abs error, that over max|ref|, the relative
    Frobenius error, the reference's largest entry and rms, and whether
    the error is within the limits. Returns ({name: errors}, all ok)."""
    out = {}
    for name, a, b in zip(("dq", "dk", "dv", "ds" if per_bh else "dbias"), got, ref):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ref_max, ref_norm = b.abs().max().item(), b.norm().item()
        frob = (a - b).norm().item() / ref_norm
        tol_frob, tol_max = (GRAD_FROB_TOL, GRAD_MAX_TOL) if name in ("dq", "dk", "dv") \
            else (DS_REL_ATOL, DS_REL_ATOL)
        out[name] = dict(max=err, max_rel=err / ref_max, frob=frob, ref_max=ref_max,
                         ref_rms=ref_norm / b.numel() ** 0.5,
                         ok=bool(torch.isfinite(a).all()) and frob <= tol_frob
                         and err <= tol_max * ref_max)
    return out, all(e["ok"] for e in out.values())


def _grad_report(errs):
    return " ".join(f"{n}: max {e['max']:.3e} ({e['max_rel']:.2e} of max|plain| {e['ref_max']:.3e}, "
                    f"rms {e['ref_rms']:.3e}) frob {e['frob']:.2e}" for n, e in errs.items()) \
        + f" (dq/dk/dv limits frob {GRAD_FROB_TOL}, max {GRAD_MAX_TOL}; dbias/ds {DS_REL_ATOL})"


def check_flash(label, shape, causal=False, per_bh=False, backward=True, plant_faults=False):
    """Kernel B3 and, with ``backward``, the one backward pass (dq, dk, dv
    and the bias gradient: B4-dq, B4-dkv and B5, or ds for a per-(b, h)
    bias) against their plain versions at one shape, each run twice for
    equal bits, with their times; with ``plant_faults`` also shows that the
    gradient limits fail the pass run on wrong inputs. Returns one row per
    kernel."""
    import torch.nn.functional as F

    from ofasys_torch.ops import flash_attention as fl

    B, Tq, Tk, H, D = shape
    scale = (2 * D) ** -0.5                   # the model's (head_dim * attn_scale_factor) ** -0.5
    q, k, v, bias, mask, do = _flash_inputs(B, Tq, Tk, H, D, SEED, per_bh)
    nb = bias.shape[0]
    tag = f"[{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}{' causal' if causal else ''}" \
          f"{' per-(b,h) bias' if per_bh else ''}]"
    out, lse = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fl.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal)
    err_out = (out.float() - ref.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = bool(torch.isfinite(out.float()).all()) and err_out <= OUT_ATOL and err_lse <= LSE_ATOL
    again = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    log(f"kernel flash_attention_fwd {tag}: max|out-plain|={err_out:.3e} (atol {OUT_ATOL}) "
        f"max|lse-plain|={err_lse:.3e} (atol {LSE_ATOL}), the same bits twice: {same} "
        f"-> {'ok' if ok and same else 'FAIL'}")
    if not ok or not same:
        raise SystemExit(f"flash_attention_fwd disagrees with its plain version at {label}")
    # planted fault: the kernel with keys 64-127 left out (a skipped key
    # tile) must fail the out or the lse limit
    hidden = mask.clone()
    hidden[:, :, 64:128] = 0
    f_out, f_lse = fl.flash_attention_fwd(q, k, v, bias, hidden, H, scale, causal)
    f_err_out = (f_out.float() - ref.float()).abs().max().item()
    f_err_lse = (f_lse - ref_lse).abs().max().item()
    caught = f_err_out > OUT_ATOL or f_err_lse > LSE_ATOL
    log(f"  planted fault keys 64-127 left out: max|out-plain|={f_err_out:.3e} "
        f"max|lse-plain|={f_err_lse:.3e} -> {'fails the limits' if caught else 'PASSES the limits'}")
    if not caught:
        raise SystemExit(f"{label}: the out/lse limits pass B3 with a key tile left out")
    del again, hidden, f_out, f_lse
    bounds = _flash_bounds(B, Tq, Tk, H, D, nb, causal)
    rows = {}

    def row(name, err, kernel_ms, plain_ms, library_ms):
        bound_ms, bound_by = _bound(*bounds[name])
        rows[name] = dict(shape=label, B=B, Tq=Tq, Tk=Tk, causal=causal, per_bh=per_bh, err=err,
                          kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        lib = "not timed" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  times {name} {tag}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib}, bound {bound_ms:.5f} ms ({bound_by}; {bounds[name][0]} B, {bounds[name][1]} FLOP)")

    q4, k4, v4, add = _flash_sdpa(q, k, v, bias, mask, H, D, causal)
    row("flash_attention_fwd", err_out,
        time_ms(lambda: fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal), **FLASH_TIMING),
        time_ms(lambda: fl.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal),
                **FLASH_TIMING),
        time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add, scale=scale),
                **FLASH_TIMING))
    rows["flash_attention_fwd"]["err_lse"] = err_lse
    del q4, k4, v4, add
    if not backward:
        return rows

    dd = (do.float() * out.float()).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, dd, bias, mask, H, scale, causal)
    ref_grads = fl.flash_attention_bwd_reference(*args)
    plan = fl.backward_plan(B, H, Tq, Tk, D, nb != B * H,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            fl.SCRATCH_CAP)
    got = fl.flash_attention_bwd(*args)
    errs, ok = grad_errors(got, ref_grads, per_bh)
    again = fl.flash_attention_bwd(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # each part wrapper returns its part of the one pass
    dq1, ds1 = fl.flash_attention_bwd_dq(*args, want_ds=nb == B * H)
    parts = [torch.equal(dq1, got[0]), *(torch.equal(a, b) for a, b in
                                        zip(fl.flash_attention_bwd_dkv(*args), got[1:3]))]
    parts.append(torch.equal(ds1 if nb == B * H else fl.flash_attention_bwd_dbias(*args), got[3]))
    log(f"kernel flash_attention_bwd {tag}: {_grad_report(errs)}; plan {plan._asdict()} "
        f"(scratch {4 * (plan.dq_scratch + plan.dbias_scratch) / 2 ** 20:.1f} MiB); the same "
        f"bits twice: {same}; the part wrappers give its parts: {all(parts)} "
        f"-> {'ok' if ok and same and all(parts) else 'FAIL'}")
    if not ok or not same or not all(parts):
        raise SystemExit(f"the flash backward disagrees with its plain version at {label}")
    del again, dq1, ds1
    if plant_faults:
        # the same kernel on wrong inputs must fail the same limits: dd
        # zeroed (a kernel that dropped it) moves dq, dk and the bias
        # gradient; keys 64-127 masked (a kernel that skipped that key
        # tile) moves all four
        hidden = mask.clone()
        hidden[:, :, 64:128] = 0
        faults = {"dd=0": ((q, k, v, do, lse, torch.zeros_like(dd), bias, mask, H, scale, causal),
                           ("dq", "dk", "ds" if per_bh else "dbias")),
                  "key tile 64-127 skipped": ((q, k, v, do, lse, dd, bias, hidden, H, scale, causal),
                                              tuple(errs))}
        for fault, (fargs, moved) in faults.items():
            ferrs, _ = grad_errors(fl.flash_attention_bwd(*fargs), ref_grads, per_bh)
            caught = [n for n in moved if not ferrs[n]["ok"]]
            log(f"  planted fault {fault}: "
                + " ".join(f"{n} frob {ferrs[n]['frob']:.2e} max {ferrs[n]['max_rel']:.2e}"
                           for n in moved)
                + f" -> fails the limits for {caught} of {list(moved)}")
            if caught != list(moved):
                raise SystemExit(f"{label}: the gradient limits pass a kernel with {fault}")
        del hidden
    plain_ms = time_ms(lambda: fl.flash_attention_bwd_reference(*args), **FLASH_TIMING)
    q4, k4, v4, b4, neg = _flash_sdpa(q, k, v, bias, mask, H, D, causal, grad=True)
    library_ms = _flash_sdpa_bwd_ms(q4, k4, v4, b4, neg, do.view(B, Tq, H, D).transpose(1, 2), scale)
    del q4, k4, v4, b4, neg
    row("flash_attention_bwd", max(e["max"] for e in errs.values()),
        time_ms(lambda: fl.flash_attention_bwd(*args), **FLASH_TIMING), plain_ms, library_ms)
    bias_err = errs["ds" if per_bh else "dbias"]["max"]
    rows["flash_attention_bwd"].update(
        err_dq=max(errs["dq"]["max"], bias_err if nb == B * H else 0.0),
        err_dkv=max(errs["dk"]["max"], errs["dv"]["max"]), err_dbias=bias_err, plan=plan._asdict())
    return rows


def flash_bwd_breakdown(label, shape):
    """Where the one flash backward pass spends its time at one shape, for
    PERF.md (no check): with no bias, a bias that needs no gradient, a
    per-(b, h) bias (ds written) and a shared one (its chunk partials read,
    added and written back per sample); the shared case with one chunk and
    with twice the plan's; and the pass's kernels by device time
    (torch.profiler, per call)."""
    from torch.profiler import ProfilerActivity, profile

    from ofasys_torch.ops import flash_attention as fl

    B, Tq, Tk, H, D = shape
    scale = (2 * D) ** -0.5
    res = {}
    for kind in ("no_bias", "bias_without_gradient", "per_bh_ds", "shared_dbias"):
        q, k, v, bias, mask, do = _flash_inputs(B, Tq, Tk, H, D, SEED, kind == "per_bh_ds")
        bias = None if kind == "no_bias" else bias
        out, lse = fl.flash_attention_fwd(q, k, v, bias, mask, H, scale, False)
        dd = (do.float() * out.float()).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, do, lse, dd, bias, mask, H, scale, False)
        want = kind != "bias_without_gradient"
        res[kind] = time_ms(lambda: fl.flash_attention_bwd(*args, want_dbias=want), **FLASH_TIMING)
    plan = fl.backward_plan(B, H, Tq, Tk, D, True,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            fl.SCRATCH_CAP)
    orig = fl.backward_plan
    for chunks in (1, 2 * plan.chunks):
        alt = plan._replace(chunks=chunks, dbias_scratch=chunks * H * Tq * Tk if chunks > 1 else 0)
        fl.backward_plan = lambda *a, _alt=alt, **kw: _alt
        try:
            res[f"shared_dbias_chunks_{chunks}"] = time_ms(lambda: fl.flash_attention_bwd(*args),
                                                           **FLASH_TIMING)
        finally:
            fl.backward_plan = orig
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl.flash_attention_bwd(*args)
        torch.cuda.synchronize()
    res["kernels_ms"] = {e.key.split("(")[0][:60]: e.device_time_total / 1e3 / 5
                         for e in prof.key_averages() if e.device_time_total > 0}
    log(f"  flash_attention_bwd breakdown [{label} B={B} Tq={Tq} Tk={Tk} H={H} D={D}, plan chunks "
        f"{plan.chunks}]: " + ", ".join(f"{n} {v:.4f} ms" for n, v in res.items() if n != "kernels_ms")
        + "; by kernel " + ", ".join(f"{n} {v:.4f} ms" for n, v in res["kernels_ms"].items()))
    return res


def phase_flash_kernels(serve_shapes, train_shapes):
    """Kernel B3 at every serving shape of the long paths (``serve_shapes``:
    [(label, (B, T))]); B3 and the one backward pass at every flash call of
    the long training update (``train_shapes``: [(label, (B, Tq, Tk),
    causal)]), at a per-(b, h) bias (ds) and at a ragged shape whose keys
    are not a multiple of the 64-key tile, all at the base arch's H=12,
    D=64, and at FLASH_EDGE_SHAPES; both planted faults at each of those;
    the backward's breakdown (flash_bwd_breakdown) at the largest training
    call. Returns {kernel name: [rows]}."""
    rows = {name: [] for name in KERNELS if name.startswith("flash")}

    def add(r):
        for name, v in r.items():
            rows[name].append(v)

    for label, (B, T) in serve_shapes:
        add(check_flash(label, (B, T, T, 12, 64), backward=False))
    extra = [("per_bh_causal", (2, 300, 300), True, True), ("ragged", (2, 300, 333), False, False)]
    for label, (B, Tq, Tk), causal, per_bh in [s + (False,) for s in train_shapes] + extra:
        add(check_flash(label, (B, Tq, Tk, 12, 64), causal, per_bh, plant_faults=True))
    for label, shape, causal in FLASH_EDGE_SHAPES:
        add(check_flash(label, shape, causal, plant_faults=True))
    # the breakdown at the largest training call
    label, (B, Tq, Tk), _ = max(train_shapes, key=lambda c: c[1][0] * c[1][1] * c[1][2])
    row = next(r for r in rows["flash_attention_bwd"] if r["shape"] == label)
    row["breakdown"] = flash_bwd_breakdown(label, (B, Tq, Tk, 12, 64))
    return rows


def _int_mm_ms(xq, sx, q, scale):
    """The library yardstick of B7: ``torch._int_mm`` (cuBLASLt int8, int32
    out) plus the same epilogue, where its shape rules allow (K and N
    multiples of 8; else None). It refuses M <= 16, so such a product is
    timed padded with zero rows to M = 32 (the least work it accepts for
    the same function)."""
    M, K = xq.shape
    N = q.shape[0]
    if K % 8 or N % 8:
        return None
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros(32 - M, K)])
        sx = torch.cat([sx, sx.new_zeros(32 - M, 1)])
    qt = q.t()
    try:
        return time_ms(lambda: ((torch._int_mm(xq, qt).float() * sx) * scale).to(torch.bfloat16))
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library int8 product not timed: {str(e).splitlines()[0][:120]}")
        return None


def check_int8(label, M, K, N):
    """Kernel B7 against its plain version at one (M, K, N), bit for bit,
    with its plan (``int8_plan``: kernel, tile, K split) and its times: the
    kernel, the plain version, the library's int8 product with the same
    epilogue, and (for context) the bf16 ``F.linear`` of the same product.
    A planted fault, one K slice of xq left out (the last cluster rank's
    share under a split, else the last 64 bytes), must change the bits."""
    import torch.nn.functional as F

    from ofasys_torch.ops.int8_matmul import (int8_matmul_fwd, int8_matmul_reference, int8_plan,
                                              split_ranges)
    from ofasys_torch.ops.quant import _quantize_rows, quantize_weight

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, device="cuda", generator=g) * K ** -0.5
    xq, sx = _quantize_rows(x)
    q, scale = quantize_weight(w)
    plan = int8_plan(M, N, K, xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    out = int8_matmul_fwd(xq, sx, q, scale, torch.bfloat16)
    torch.cuda.synchronize()
    ref = int8_matmul_reference(xq, sx, q, scale, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    equal = torch.equal(out, ref)
    plan_s = (f"{plan.kernel} {plan.tile_m}x{plan.tile_n} split {plan.split}, "
              f"{plan.blocks(M, N)} blocks")
    log(f"kernel int8_matmul_fwd [{label} M={M} K={K} N={N}; {plan_s}]: bit-equal to its plain "
        f"version: {equal} (max |out-plain| {err:.3e}) -> {'ok' if equal else 'FAIL'}")
    if not equal:
        raise SystemExit(f"int8_matmul_fwd differs from its plain version at {label}")
    k0, k1 = split_ranges(K, plan.split)[-1] if plan.split > 1 else (max(0, K - 64), K)
    cut = xq.clone()
    cut[:, k0:k1] = 0
    caught = not torch.equal(int8_matmul_fwd(cut, sx, q, scale, torch.bfloat16), ref)
    log(f"  planted fault K bytes {k0}-{k1 - 1} left out: "
        f"{'caught by bit-equality' if caught else 'NOT caught'}")
    if not caught:
        raise SystemExit(f"{label}: bit-equality passes B7 with a K slice left out")
    del cut
    wb = w.to(torch.bfloat16)
    kernel_ms = time_ms(lambda: int8_matmul_fwd(xq, sx, q, scale, torch.bfloat16))
    plain_ms = time_ms(lambda: int8_matmul_reference(xq, sx, q, scale, torch.bfloat16), n=10)
    library_ms = _int_mm_ms(xq, sx, q, scale)
    bf16_ms = time_ms(lambda: F.linear(x, wb))
    n_bytes = M * K + N * K + 4 * M + 4 * N + 2 * M * N
    ops = 2 * M * N * K
    bound_ms, bound_by = _bound(n_bytes, ops, PEAK_INT8_OPS)
    lib = "not timed (shape rules)" if library_ms is None else \
        f"{library_ms:.4f} ms{' (padded to M = 32)' if M <= 16 else ''}"
    log(f"  times [{label}]: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(torch._int_mm + epilogue) {lib}, bf16 F.linear {bf16_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {ops} int8 OP)")
    return dict(shape=label, M=M, K=K, N=N, plan=vars(plan), err=err, bit_equal=equal,
                fault_caught=caught, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bf16_linear_ms=bf16_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_int8_kernels(encoder_rows, vocab):
    """Kernel B7 at serve_int8's shapes: the tied logits of a beam-5 and a
    greedy decode step over ``vocab`` symbols, a beam-5 decode step's fc1,
    fc2 and q/k/v/out (8 requests x beam 5 = 40 rows), a greedy step's
    q/k/v/out (4 rows), the encoder's fc1, fc2 and q/k/v/out at the largest
    dispatch's B*T rows, and a ragged shape (K % 16 != 0: the __dp4a
    kernel). Every plan of ``int8_plan`` the path takes is among them."""
    shapes = [("decode_logits", 40, 768, vocab), ("greedy_logits", 4, 768, vocab),
              ("decode_fc1", 40, 768, 3072), ("decode_fc2", 40, 3072, 768),
              ("decode_qkv", 40, 768, 768), ("greedy_qkv", 4, 768, 768),
              ("encoder_fc1", encoder_rows, 768, 3072), ("encoder_fc2", encoder_rows, 3072, 768),
              ("encoder_qkv", encoder_rows, 768, 768), ("ragged", 300, 200, 333)]
    return [check_int8(*s) for s in shapes]


def _rel_errors(a, r):
    """max |a - r|, that over max |r|, and the relative Frobenius error."""
    a, r = a.float(), r.float()
    e = (a - r).abs().max().item()
    return dict(max=e, max_rel=e / r.abs().max().item(), frob=((a - r).norm() / r.norm()).item())


def _ln_library_ms(x, w, b, dy):
    """The library yardsticks of B6: ``F.layer_norm`` forward, and autograd
    of it minus its forward. PyTorch's CUDA LayerNorm takes g and b in x's
    dtype only, so they are rounded to it outside the timed calls (its
    statistics are fp32 all the same)."""
    import torch.nn.functional as F

    E = x.shape[1]
    xs, ws, bs = (t.detach().to(x.dtype).requires_grad_() for t in (x, w, b))

    def fwd():
        return F.layer_norm(xs, (E,), ws, bs, 1e-5)

    try:
        with torch.no_grad():
            f_ms = time_ms(fwd)
        both = time_ms(lambda: torch.autograd.grad(fwd(), (xs, ws, bs), dy))
    except RuntimeError as e:               # a yardstick only: the port never calls it
        log(f"  library LayerNorm not timed: {str(e).splitlines()[0][:120]}")
        return None, None
    return f_ms, both - f_ms


def check_ln(label, N, E):
    """Kernels B6-fwd and B6-bwd against their plain versions at one (N, E)
    in bf16, with their times, and a planted fault: dg summed over all rows
    but one must fail LN_SUM_TOL. Returns (forward row, backward row)."""
    from ofasys_torch.ops import layer_norm as tln

    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.randn(N, E, device="cuda", generator=g) * 2.0 + 0.5).to(torch.bfloat16)
    dy = torch.randn(N, E, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(E, device="cuda", generator=g) * 0.3 + 1.0
    b = torch.randn(E, device="cuda", generator=g) * 0.1
    y, mu, rstd = tln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dg, db = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    ry, rmu, rrstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5)
    rdx, rdg, rdb = tln.layer_norm_bwd_reference(x, w, mu, rstd, dy)
    dy_err = (y.float() - ry.float()).abs()
    y_ok = bool((dy_err <= 2.0 ** -7 * ry.float().abs() + 1e-3).all())
    stat_err = max(((mu - rmu).abs() / rmu.abs().clamp(min=1e-6)).max().item(),
                   ((rstd - rrstd).abs() / rrstd.abs()).max().item())
    errs = {n: _rel_errors(a, r) for n, a, r in (("dx", dx, rdx), ("dg", dg, rdg), ("db", db, rdb))}
    ok_dx = errs["dx"]["frob"] <= GRAD_FROB_TOL and errs["dx"]["max_rel"] <= GRAD_MAX_TOL \
        and bool(torch.isfinite(dx.float()).all())
    ok_sums = all(errs[n]["frob"] <= LN_SUM_TOL and errs[n]["max_rel"] <= LN_SUM_TOL
                  for n in ("dg", "db"))
    ok = y_ok and stat_err <= 1e-5 and ok_dx and ok_sums
    fplan = tln.ln_fwd_plan(E, x.element_size())
    tag = f"[{label} N={N} E={E} bf16; B6-fwd {fplan.kernel} {fplan.warps}x{fplan.slots}]"
    log(f"kernels layer_norm_fwd/bwd {tag}: max|y-plain| {dy_err.max().item():.3e} (one bf16 ulp), "
        f"mu/rstd rel {stat_err:.2e} (1e-5); "
        + " ".join(f"{n} frob {v['frob']:.2e} max {v['max_rel']:.2e}" for n, v in errs.items())
        + f" (dx {GRAD_FROB_TOL}/{GRAD_MAX_TOL}, dg/db {LN_SUM_TOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"layer_norm kernels disagree with their plain versions at {label}")
    skip = dy.clone()
    skip[N // 2] = 0
    _, fdg, _ = tln.layer_norm_bwd(x, w, mu, rstd, skip)
    fault = _rel_errors(fdg, rdg)
    caught = fault["frob"] > LN_SUM_TOL or fault["max_rel"] > LN_SUM_TOL
    log(f"  planted fault dg without row {N // 2}: frob {fault['frob']:.2e} max "
        f"{fault['max_rel']:.2e} -> {'caught' if caught else 'NOT caught'}")
    if not caught:
        raise SystemExit(f"{label}: LN_SUM_TOL passes a dg that skipped a row")
    lib_f, lib_b = _ln_library_ms(x, w, b, dy)
    sz = x.element_size()
    fwd_bytes, fwd_ops = 2 * N * E * sz + 8 * E + 8 * N, 8 * N * E
    bwd_bytes, bwd_ops = 3 * N * E * sz + 8 * N + 12 * E, 12 * N * E
    rows = []
    for name, kernel, plain, lib, n_bytes, ops, err in (
            ("layer_norm_fwd", lambda: tln.layer_norm_fwd(x, w, b, 1e-5),
             lambda: tln.layer_norm_fwd_reference(x, w, b, 1e-5), lib_f, fwd_bytes, fwd_ops,
             dy_err.max().item()),
            ("layer_norm_bwd", lambda: tln.layer_norm_bwd(x, w, mu, rstd, dy),
             lambda: tln.layer_norm_bwd_reference(x, w, mu, rstd, dy), lib_b, bwd_bytes, bwd_ops,
             max(e["max"] for e in errs.values()))):
        bound_ms, bound_by = _bound(n_bytes, ops, PEAK_FP32_FLOPS)
        k_ms, p_ms = time_ms(kernel), time_ms(plain)
        lib_s = "not timed" if lib is None else f"{lib:.4f} ms"
        log(f"  times {name} {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"(F.layer_norm{'' if name.endswith('fwd') else ' backward'}) {lib_s}, bound "
            f"{bound_ms:.5f} ms ({bound_by}; {n_bytes} B, {ops} FLOP)")
        rows.append(dict(shape=label, N=N, E=E, err=err, kernel_ms=k_ms, plain_ms=p_ms,
                         library_ms=lib, bound_ms=bound_ms, bound_by=bound_by,
                         **({"plan": vars(fplan)} if name == "layer_norm_fwd" else {})))
    return rows


def phase_ln_kernels(batches):
    """Kernels B6-fwd and B6-bwd at the train mix's LayerNorm shapes (each
    task's encoder and decoder rows at E = 768, the encoder rows of the
    first task at fc2_ln's 3,072), a decode step and a ragged N; then at
    E = 1,024 and 4,096 (the large arch's width and FFN width: B6-fwd's row
    in registers with one warp and with a group of six) and at an odd E =
    1,001 (the two-walk kernel). Returns {kernel name: [rows]}."""
    shapes = []
    for i, (name, b) in enumerate(batches.items()):
        B, Ts, Tt = _task_shapes(b)
        shapes += [(f"{name}_encoder", B * Ts, 768), (f"{name}_decoder", B * Tt, 768)]
        if i == 0:
            shapes.append((f"{name}_encoder_fc2_ln", B * Ts, 3072))
    shapes += [("decode_step", 40, 768), ("ragged", 1001, 768), ("E1024", 12288, 1024),
               ("E4096", 12288, 4096), ("E1001_odd", 12288, 1001)]
    rows = {"layer_norm_fwd": [], "layer_norm_bwd": []}
    for label, N, E in shapes:
        f, bw = check_ln(label, N, E)
        rows["layer_norm_fwd"].append(f)
        rows["layer_norm_bwd"].append(bw)
    return rows


class RecordingHub:
    """Passes ``inference`` through to the hub and records each dispatch the
    server makes, so the same batches can be replayed directly, and the
    decode steps each dispatch ran (``steps``)."""

    def __init__(self, hub):
        self.hub = hub
        self.device = hub.device
        self.calls = []
        self.steps = []

    def inference(self, instruction, data=None, **kw):
        net = self.hub.model.net
        orig, n = net.decode_step, [0]

        def counted(*a, **k):
            n[0] += 1
            return orig(*a, **k)

        net.decode_step = counted
        try:
            out = self.hub.inference(instruction, data, **kw)
        finally:
            del net.decode_step
        self.calls.append((instruction, data, kw, out))
        self.steps.append(n[0])
        return out


def _requests(tpl=TPL, lengths=SERVE_SRC, seed=SEED, fixed=None):
    """The 16 requests of a serving run: (data, generation overrides), 12
    with the hub's TEXT defaults and 4 greedy, sources of ``lengths`` bytes
    (``fixed``: {request index: bytes} set after the draw)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lengths[0], lengths[1] + 1, size=N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    for i, n in (fixed or {}).items():
        sizes[i] = n
    srcs = _sources(rng, sizes)
    reqs = [({"src": s}, {"max_len_b": MAX_LEN_B}) for s in srcs[:N_BEAM_REQUESTS]]
    reqs += [({"src": s}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for s in srcs[N_BEAM_REQUESTS:]]
    return reqs


def _serve_requests():
    """serve: sources of 40-200 bytes; the first request of the 2nd and 3rd
    dispatch (4 records each) has 160, so every dispatch has B*T >= 256
    and meets kernel B1's gate."""
    return _requests(fixed={N_BEAM_REQUESTS - 4: 160, N_BEAM_REQUESTS: 160})


def _long_requests():
    """serve_long: summarization requests with sources of 600-960 bytes."""
    return _requests(SUMMARY_TPL, LONG_SRC, SEED + 2)


def _truncated_requests():
    """serve_truncated: one dispatch of 8 requests with sources of 300-400
    bytes, cut to 257 tokens under the default max_src_length of 256."""
    return _requests(SUMMARY_TPL, TRUNC_SRC, SEED + 3)[:8]


def _encoder_tokens(slots):
    """(B, T) of the encoder's input: a text slot counts its tokens, an
    image slot its patches."""
    from ofasys_torch.adaptor.image import PATCH_SIZE

    B = T = 0
    for s in slots:
        if s.is_src:
            a = s.value["inputs"]
            B = a.shape[0]
            T += a.shape[1] if a.ndim == 2 else (a.shape[1] // PATCH_SIZE) * (a.shape[2] // PATCH_SIZE)
    return B, T


def _encoder_shape(gp, recs, tpl=TPL):
    from ofasys_torch.preprocessor.instruction import Instruction

    sample = gp.collate([gp(Instruction(tpl, split="test").format(**r)) for r in recs])
    return _encoder_tokens(sample["net_input"]["slots"])


def _images(rng, n, size=IMAGE_SIZE):
    """``n`` uint8-valued float32 (size, size, 3) arrays: at the
    preprocessor's size, so they need no resize."""
    return [rng.integers(0, 256, (size, size, 3)).astype(np.float32) for _ in range(n)]


def _caption_requests():
    """serve_caption: 16 images, 12 with the hub's TEXT defaults (beam 5) and
    4 greedy."""
    imgs = _images(np.random.default_rng(SEED + 5), N_BEAM_REQUESTS + N_GREEDY_REQUESTS)
    reqs = [({"img": a}, {"max_len_b": MAX_LEN_B}) for a in imgs[:N_BEAM_REQUESTS]]
    reqs += [({"img": a}, {"max_len_b": MAX_LEN_B, "beam_size": 1}) for a in imgs[N_BEAM_REQUESTS:]]
    return reqs


def _same_record(a, b):
    """Two request records hold the same values (arrays by identity)."""
    return a is not None and a.keys() == b.keys() and all(
        a[k] is b[k] or (not isinstance(a[k], np.ndarray) and a[k] == b[k]) for k in a)


def planned_dispatch_shapes(gp=None, reqs=None, tpl=TPL):
    """(B, T) of the encoder in each dispatch the server will make: the
    first 8 beam requests, the other 4 beam requests, the 4 greedy ones."""
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    gp = gp or GeneralPreprocess(Dictionary(), active=["text", "image"])
    recs = [r for r, _ in (reqs or _serve_requests())]
    groups = (recs[:8], recs[8:N_BEAM_REQUESTS], recs[N_BEAM_REQUESTS:])
    return [_encoder_shape(gp, g, tpl) for g in groups if g]


def _sources(rng, lengths):
    words = ["the", "model", "serves", "a", "batch", "of", "text", "requests", "on", "one", "card",
             "with", "beam", "search", "and", "greedy", "decoding", "over", "fifty", "thousand",
             "symbols", "quick", "brown", "fox", "jumps", "lazy", "dog", "12", "345", "north"]
    out = []
    for L in lengths:
        s = ""
        while len(s) < L:
            s += rng.choice(words) + " "
        out.append(s[:L].strip().ljust(L, "x"))
    return out


def _per_dispatch(net):
    """Launches of B7 and B6-fwd in one serving dispatch of S decode steps,
    as (once, per step), counted from the net's modules: B7 on every int8
    projection of the encoder and on the decoder's cross k/v (projected
    once, in decode_prepare), then on the other decoder projections and the
    tied logits at every step; B6-fwd on every fused LayerNorm of the
    encoder, then of the decoder at every step."""
    from ofasys_torch.ops.layer_norm import FusedLayerNorm
    from ofasys_torch.ops.quant import is_quantized

    def count(prefix, pred):
        return sum(1 for n, m in net.named_modules() if n.startswith(prefix) and pred(n, m))

    def int8(n, m):
        return is_quantized(m)

    def cross_kv(n, m):
        return is_quantized(m) and n.endswith(("encoder_attn.k_proj", "encoder_attn.v_proj"))

    def fused(n, m):
        return isinstance(m, FusedLayerNorm) and m.mode == "fused"

    cross = count("decoder.", cross_kv)
    logits = int(is_quantized(net.embed_tokens))
    return {"int8_matmul_fwd": (count("encoder.", int8) + cross,
                                count("decoder.", int8) - cross + logits),
            "layer_norm_fwd": (count("encoder.", fused), count("decoder.", fused))}


def _expected_launches(gp, calls, steps, net, tpl=TPL):
    """Per dispatch (B, T, route) and the kernel launches the dispatches
    should make: one per encoder layer of kernel B3 (flash, T >= 256) or B1
    (dense gate), none on the plain path; B7 and B6-fwd by
    :func:`_per_dispatch` for each dispatch's decode steps."""
    cfg = net.cfg
    shapes, expected = [], dict.fromkeys(KERNELS, 0)
    per = _per_dispatch(net)
    for (_, data, _, _), S in zip(calls, steps, strict=True):
        B, T = _encoder_shape(gp, data if isinstance(data, list) else [data], tpl)
        route = _route(cfg, B, T, T)
        shapes.append((B, T, route))
        if route != "plain":
            expected[f"{route}_attention_fwd"] += cfg.encoder.layers
        for name, (once, step) in per.items():
            expected[name] += once + step * S
    return shapes, expected


def build_base_hub():
    """The base arch at full width (E=768, FFN 3072, 12 heads, 6+6 layers)
    with 50,000 ``<text>_i`` symbols padded to a multiple of 128, random
    weights from SEED, bf16 compute on the card."""
    from ofasys_torch import GeneralistModel, OFASys
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    t0 = time.perf_counter()
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "image"])   # registers <text>_0..255 and <mask>
    for i in range(256, 50000):                       # GPT-2-scale text vocabulary
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(128)
    model = GeneralistModel(arch="base")
    model.cfg.dropout = 0.0
    model.initialize(d, active_adaptors=ACTIVE_ADAPTORS, dtype=torch.bfloat16, device="cuda", seed=SEED)
    hub = OFASys(model, None, d, gp)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.net.parameters())
    log(f"slice: base arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} adaptors={ACTIVE_ADAPTORS} params={n_params} "
        f"built in {time.perf_counter() - t0:.1f} s")
    return hub


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_and_check(hub, card, tpl=TPL, reqs=None, label="serve", check_encoder=True):
    """Drive the serving path with the requests (default: the serve run's 16) and
    check what comes out; returns the kernel launch counts of that run
    (``launches``), its p50 latency, tokens/s, answers, and the dispatches
    with their decode steps. ``check_encoder`` holds the encoder output
    under the attention kernel against plain attention (ENC_REL_TOL)."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.serve import InferenceServer
    from ofasys_torch.utils.pytree import slots_to_device

    gp, model = hub.general_preprocess, hub.model
    cfg = model.cfg
    reqs = reqs or _serve_requests()
    on_card = hub.device.type == "cuda"

    # warm-up (cuBLAS handles, allocator) outside the measured run
    hub.inference(tpl, [r for r, _ in reqs[:8]], max_len_b=4)
    hub.inference(tpl, [r for r, _ in reqs[:4]], max_len_b=4, beam_size=1)
    _sync(hub.device)

    rec = RecordingHub(hub)
    srv = InferenceServer(rec, max_batch=8, max_wait_ms=50.0, device=hub.device)
    try:
        reset_counts()
        t_start = time.perf_counter()
        futs = [srv.submit(tpl, data, **opts) for data, opts in reqs]
        outs = [f.result(timeout=600) for f in futs]
        _sync(hub.device)
        wall = time.perf_counter() - t_start
        launches = read_counts()
    finally:
        srv.close()
    stats = srv.stats()

    for i, o in enumerate(outs):
        if not (np.isfinite(o.score) and isinstance(o.text, str) and o.tokens.size > 0):
            raise SystemExit(f"{label} request {i}: bad answer {o!r}")
    n_tokens = int(sum(o.tokens.size for o in outs))
    shapes, expected = _expected_launches(gp, rec.calls, rec.steps, model.net, tpl)
    launched = {n: c for n, c in launches.items() if c or expected[n]}
    log(f"  {label} dispatches (B, T, encoder route): {shapes}, decode steps {rec.steps}")
    for name, (once, step) in _per_dispatch(model.net).items():
        if once or step:
            log(f"  {label} {name} per dispatch: {once} + {step} * S = "
                f"{[once + step * S for S in rec.steps]}")
    log(f"  {label} launches: {launched} (expected {({n: c for n, c in expected.items() if c})})")
    if on_card and (launches != expected or any(route == "plain" for *_, route in shapes)):
        raise SystemExit(f"{label}: a kernel did not run as often as the path calls it")
    log(f"  {label}: served {stats['requests']} requests in {stats['batches']} batches, "
        f"p50 latency {stats['p50_latency_ms']} ms, {n_tokens} tokens in {wall:.3f} s = "
        f"{n_tokens / wall:.1f} tokens/s [{card}]")
    res = dict(launches=launches, p50_ms=stats["p50_latency_ms"], tokens_per_s=n_tokens / wall,
               outs=outs, calls=rec.calls, steps=rec.steps)
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
    misrouted = sum(not _same_record(where.get(id(o)), data) for o, (data, _) in zip(outs, reqs))
    log(f"  served vs direct hub.inference on the same batches: {mismatches} mismatches, "
        f"{misrouted} answers routed to the wrong request")
    if mismatches or misrouted:
        raise SystemExit(f"{label}: served answers differ from direct inference")

    if not check_encoder:
        return res
    # encoder output of the first dispatch's records, kernel vs plain attention
    recs = [r for r, _ in reqs[:8]]
    sample = gp.collate([gp(Instruction(tpl, split="test").format(**r)) for r in recs])
    src = slots_to_device([s for s in sample["net_input"]["slots"] if s.is_src], hub.device)
    kernel = f"{shapes[0][2]}_attention_fwd"
    saved = cfg.attn_kernel, cfg.use_flash_attention
    with torch.no_grad():
        before = read_counts().get(kernel, 0)
        enc_kernel = model.net.encode(src).x.float()
        used = read_counts().get(kernel, 0) - before
        cfg.attn_kernel, cfg.use_flash_attention = "xla", False
        try:
            enc_plain = model.net.encode(src).x.float()
        finally:
            cfg.attn_kernel, cfg.use_flash_attention = saved
    rel = ((enc_kernel - enc_plain).norm() / enc_plain.norm()).item()
    mx = (enc_kernel - enc_plain).abs().max().item()
    log(f"  encoder output {kernel} vs plain attention {tuple(enc_kernel.shape)}: "
        f"rel {rel:.3e} (tol {ENC_REL_TOL}), max abs {mx:.3e} (tol {ENC_ABS_TOL}), "
        f"kernel launches {used}")
    if (on_card and used != cfg.encoder.layers) or not rel <= ENC_REL_TOL or not mx <= ENC_ABS_TOL:
        raise SystemExit(f"{label}: encoder output under {kernel} disagrees with plain attention")
    return res


def long_preprocess(d):
    """The text preprocessor with max_src_length and max_tgt_length raised
    to LONG, on the same dictionary."""
    from ofasys_torch.preprocessor.general import GeneralPreprocess
    from ofasys_torch.preprocessor.text import TextPreprocessConfig

    return GeneralPreprocess(d, active=["text", "image"],
                             text_cfg=TextPreprocessConfig(max_src_length=LONG, max_tgt_length=LONG))


def serve_long_and_check(hub, card):
    """serve_long: a hub on the same model whose text lengths are raised to
    LONG, 16 summarization requests with sources of 600-960 bytes."""
    from ofasys_torch import OFASys

    long_hub = OFASys(hub.model, None, hub.global_dict, long_preprocess(hub.global_dict),
                      device=hub.device)
    return serve_and_check(long_hub, card, SUMMARY_TPL, _long_requests(), "serve_long")


def serve_truncated_and_check(hub, card):
    """serve_truncated: one dispatch of 8 requests under the default
    max_src_length = 256: the 300-400 byte sources are cut to 257 tokens."""
    from ofasys_torch.preprocessor.instruction import Instruction

    reqs = _truncated_requests()
    gp = hub.general_preprocess
    src = gp.collate([gp(Instruction(SUMMARY_TPL, split="test").format(**r)) for r, _ in reqs])
    tokens = src["net_input"]["slots"][0].value["inputs"]
    n_tok = int((tokens != hub.global_dict.pad()).sum(1).max())
    log(f"  serve_truncated: encoder input {tokens.shape}, longest {n_tok} tokens")
    if n_tok != gp.name2pre["text"].cfg.max_src_length + 1:
        raise SystemExit("serve_truncated: the sources were not cut to max_src_length + 1")
    return serve_and_check(hub, card, SUMMARY_TPL, reqs, "serve_truncated")


def _report_profile(prof, wall_ms, what, card, share=None):
    """Wall, device busy time and idle share, launches and the top kernels;
    with ``share`` (a tuple of names), the share of device time of the
    kernels whose name holds one of them."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    log(f"profile: {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
        f"idle {100 * (1 - busy_ms / wall_ms):.1f}%, {n_launch} kernel launches [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")
    if share:
        own = [e for e in kernels if any(s in e.key for s in share)]
        own_ms = sum(e.self_device_time_total for e in own) / 1e3
        log(f"  kernels named {' or '.join(f'*{s}*' for s in share)}: {own_ms:.3f} ms in "
            f"{sum(e.count for e in own)} launches, "
            f"{100 * own_ms / max(busy_ms, 1e-9):.1f}% of device time")


def phase_profile(hub, card, share=None, tpl=TPL, reqs=None, what="one dispatch (B=8, beam 5)"):
    """One dispatch of the serving path (the first 8 requests, beam 5) under
    torch.profiler: wall time, device busy time and idle share, kernel
    launches, and the kernels that take the most device time (with
    ``share``, the share of the kernels whose name holds one of its names)."""
    from torch.profiler import ProfilerActivity, profile

    recs = [r for r, _ in (reqs or _serve_requests())[:8]]
    _sync(hub.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hub.inference(tpl, recs, max_len_b=MAX_LEN_B)
        _sync(hub.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report_profile(prof, wall_ms, what, card, share)


def serve_caption_and_check(hub, card, serve_res=None):
    """serve_caption: 16 image→text requests through the server; kernel B1 in
    every dispatch's encoder, the encoder output against plain attention;
    p50 and tokens/s beside serve's (``serve_res``)."""
    res = serve_and_check(hub, card, CAPTION_TPL, _caption_requests(), "serve_caption")
    if serve_res is not None:
        log(f"  serve_caption vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s [{card}]")
    return res


def _param_bytes(net):
    """Bytes of the net's parameters and buffers (the int8 tables and their
    scales after quantize())."""
    return sum(t.numel() * t.element_size() for t in list(net.parameters()) + list(net.buffers()))


def serve_int8_and_check(hub, card, serve_res=None):
    """serve_int8: the serve phase's requests on a deep copy of the hub's
    model after ``OFASys.quantize()`` (w8a8). Beyond serve_and_check's
    checks: the tokens of every dispatch equal those of the same quantized
    hub with B7's wrapper replaced, here only, by its plain version (the
    integer product is exact, so only the epilogue could differ); prints the
    parameter bytes before and after, p50 and tokens/s beside serve's
    (``serve_res``) and the share of answers equal to the bf16 hub's, then
    profiles one dispatch."""
    import copy

    from ofasys_torch import OFASys
    from ofasys_torch.ops import int8_matmul, quant

    model = copy.deepcopy(hub.model)
    before = _param_bytes(model.net)
    qhub = OFASys(model, None, hub.global_dict, hub.general_preprocess, device=hub.device).quantize()
    after = _param_bytes(model.net)
    int8_bytes = sum(b.numel() for b in model.net.buffers() if b.dtype == torch.int8)
    log(f"serve_int8: parameter bytes {before} before quantize(), {after} after "
        f"({after / before:.3f}x; int8 tables {int8_bytes} B)")
    # the encoder check against plain attention is left out: with int8
    # projections a rounding difference of the attention moves whole int8
    # steps, which later projections carry on (tests/test_torch_quant.py)
    res = serve_and_check(qhub, card, label="serve_int8", check_encoder=False)

    mismatches = 0
    quant.int8_matmul_fwd = int8_matmul.int8_matmul_reference
    try:
        for instruction, data, kw, out in res["calls"]:
            plain = qhub.inference(instruction, data, **kw)
            for a, b in zip(out if isinstance(data, list) else [out],
                            plain if isinstance(data, list) else [plain], strict=True):
                mismatches += not np.array_equal(a.tokens, b.tokens)
    finally:
        quant.int8_matmul_fwd = int8_matmul.int8_matmul_fwd
    log(f"  serve_int8: tokens under B7 vs its plain version on the card: {mismatches} mismatches")
    if mismatches:
        raise SystemExit("serve_int8: the tokens under B7 differ from those of its plain version")
    if serve_res is not None:
        same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(res["outs"], serve_res["outs"]))
        log(f"  serve_int8 vs serve: p50 {res['p50_ms']} vs {serve_res['p50_ms']} ms, "
            f"{res['tokens_per_s']:.1f} vs {serve_res['tokens_per_s']:.1f} tokens/s; "
            f"{same} of {len(res['outs'])} answers equal to the bf16 hub's (information) [{card}]")
    if hub.device.type == "cuda":
        phase_profile(qhub, card, share=B7_KERNEL_NAMES)
    del qhub, model
    return res


def _ln_hub(hub, impl):
    """A second model of the hub's config with ``ln_impl=impl`` and the
    hub's weights."""
    from ofasys_torch import GeneralistModel, OFASys

    model = GeneralistModel(hub.model.cfg, ln_impl=impl)
    model.initialize(hub.global_dict, active_adaptors=ACTIVE_ADAPTORS, dtype=hub.model.net.dtype,
                     device=hub.device, seed=SEED)
    model.net.load_state_dict(hub.model.net.state_dict())
    return OFASys(model, None, hub.global_dict, hub.general_preprocess, device=hub.device)


def serve_ln_and_check(hub, card):
    """serve_ln: one dispatch of the serve mix (the first 8 beam requests)
    with ln_impl='pallas' (kernel B6-fwd in every stack LayerNorm), and the
    first decode step's logits against the hub's (ln_impl='xla') on the same
    records."""
    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import slots_to_device

    ln_hub = _ln_hub(hub, "pallas")
    res = serve_and_check(ln_hub, card, reqs=_serve_requests()[:8], label="serve_ln")
    gp = hub.general_preprocess
    sample = gp.collate([gp(Instruction(TPL, split="test").format(**r))
                         for r, _ in _serve_requests()[:8]])
    slots = slots_to_device(sample["net_input"]["slots"], hub.device)
    with torch.no_grad():
        got = ln_hub.model.net(slots)[0][:, 0].float()
        ref = hub.model.net(slots)[0][:, 0].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  serve_ln: first-step logits {tuple(got.shape)}, B6 vs ln_impl='xla': rel {rel:.3e} "
        f"(tol {LN_LOGIT_REL_TOL}), max abs {(got - ref).abs().max().item():.3e}")
    if not rel <= LN_LOGIT_REL_TOL:
        raise SystemExit("serve_ln: the logits under B6 disagree with the default LayerNorm")
    del ln_hub
    return res


def train_ln_and_check(d, gp, card, arch="base", tasks=None, batches=None):
    """train_ln: the train phase's updates with ln_impl='pallas', then one
    ln_impl='hybrid' update; the gradients of each against a model with
    ln_impl='xla' and the same parameters. Returns the launch counts and
    results of both runs."""
    device = "cuda" if card != "cpu" else "cpu"
    ref = build_train_model(d, device, arch)
    out = {}
    for impl, label, n in (("pallas", "train_ln", N_UPDATES), ("hybrid", "train_ln_hybrid", 1)):
        model = build_train_model(d, device, arch, ln_impl=impl)
        counts, res, _ = train_and_check(model, gp, card, tasks=tasks, batches=batches, label=label,
                                         grad_ref=ref, n_updates=n)
        out[label] = (counts, res)
        del model
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _dense_bwd_switch(value):
    """OFASYS_DENSE_BWD set to ``value`` (None: unset) inside, restored after."""
    saved = os.environ.get("OFASYS_DENSE_BWD")
    try:
        if value is None:
            os.environ.pop("OFASYS_DENSE_BWD", None)
        else:
            os.environ["OFASYS_DENSE_BWD"] = value
        yield
    finally:
        if saved is None:
            os.environ.pop("OFASYS_DENSE_BWD", None)
        else:
            os.environ["OFASYS_DENSE_BWD"] = saved


def train_rowmajor_and_check(d, gp, card, arch="base", tasks=None, batches=None, mm_res=None):
    """train_rowmajor: train_mm's updates on a model from the same seed with
    OFASYS_DENSE_BWD=rowmajor set for the phase and restored after: kernel
    B2r once per dense attention and B2 not at all (train_and_check's launch
    check reads the switch), a falling loss, one update's gradients against
    the plain attention path; then the same update's gradients under B2r
    against B2's, from the same weights and batches (GRAD_FROB_TOL over all
    leaves: the two kernels round at the same points and differ only in the
    order of their fp32 sums). Prints the step time beside train_mm's
    (``mm_res``). Returns the launch counts and the results."""
    from ofasys_torch.engine.criterion import (
        LabelSmoothedCrossEntropyCriterion,
        LabelSmoothedCrossEntropyCriterionConfig,
    )

    device = "cuda" if card != "cpu" else "cpu"
    model = build_train_model(d, device, arch)
    with _dense_bwd_switch("rowmajor"):
        counts, res, (_, state, dev) = train_and_check(model, gp, card, tasks=tasks, batches=batches,
                                                       label="train_rowmajor")
    crit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(),
                                              pad_id=model.global_dict.pad())
    names = [n for n, _ in model.net.named_parameters()]
    saved = model.cfg.dropout
    model.cfg.dropout = 0.0
    try:
        reset_counts()
        with _dense_bwd_switch("rowmajor"):
            g_row = _grads(model, crit, state.params, state.step, dev)
        n_row = read_counts()
        reset_counts()
        with _dense_bwd_switch(None):
            g_t = _grads(model, crit, state.params, state.step, dev)
        n_t = read_counts()
    finally:
        model.cfg.dropout = saved
    rel, norm_rel, leaves = _grad_diff(names, g_row, g_t)
    log(f"  train_rowmajor: gradients of one update under B2r ({n_row['dense_attention_bwd_rowmajor']} "
        f"launches, {n_row['dense_attention_bwd']} of B2) vs under B2 ({n_t['dense_attention_bwd']} "
        f"launches, {n_t['dense_attention_bwd_rowmajor']} of B2r), same weights and batches, dropout 0: "
        f"rel {rel:.3e} (tol {GRAD_FROB_TOL}), global norm rel err {norm_rel:.3e}, worst leaves "
        f"{_top_leaves(leaves)}")
    if device == "cuda" and (n_row["dense_attention_bwd"] or n_t["dense_attention_bwd_rowmajor"]
                             or n_row["dense_attention_bwd_rowmajor"] != n_t["dense_attention_bwd"]
                             or not n_row["dense_attention_bwd_rowmajor"]):
        raise SystemExit("train_rowmajor: the switch did not move every dense backward to B2r")
    if not rel <= GRAD_FROB_TOL:
        raise SystemExit("train_rowmajor: gradients under B2r disagree with those under B2")
    res = dict(res, vs_b2_rel=rel, vs_b2_norm_rel=norm_rel)
    if mm_res is not None:
        log(f"train_rowmajor: step {res['step_ms']:.2f} ms, {res['samples_per_s']:.1f} samples/s "
            f"(train_mm: {mm_res['step_ms']:.2f} ms, {mm_res['samples_per_s']:.1f} samples/s) [{card}]")
    return counts, res


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
    """One collated batch (numpy) per task, from seeded text and images,
    through Instruction(template, split="train") -> GeneralPreprocess ->
    collate: span masking runs on the text_infilling source. A task's spec
    names its text columns with their lengths in bytes and, under ``image``,
    the side of the ``img`` column's square images."""
    from ofasys_torch.preprocessor.instruction import Instruction

    rng = np.random.default_rng(SEED + 1)
    out = {}
    for name, spec in (tasks or TRAIN_TASKS).items():
        columns = [c for c in spec if c not in ("template", "batch", "image")]
        recs = [{c: _text(rng, *spec[c]) for c in columns} for _ in range(spec["batch"])]
        if "image" in spec:
            for r, a in zip(recs, _images(rng, len(recs), spec["image"])):
                r["img"] = a
        out[name] = gp.collate([gp(Instruction(spec["template"], split="train").format(**r))
                                for r in recs])
    return out


def _task_shapes(batch):
    """(B, encoder tokens, decoder tokens) of a collated batch."""
    slots = batch["net_input"]["slots"]
    B, Ts = _encoder_tokens(slots)
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


def _expected_train_launches(batches, cfg, net=None):
    """Launches of each kernel one update should make: every attention call
    (encoder self, decoder self, cross) on the flash route runs B3 and the
    one backward pass that stands for B4-dq, B4-dkv and B5
    (flash_attention_bwd; the part wrappers launch nothing of their own);
    on the dense route B1 and B2
    (``_route``, as MultiheadAttention decides), or B1 and B2r while
    OFASYS_DENSE_BWD=rowmajor is set."""
    n = dict.fromkeys(KERNELS, 0)
    dense_bwd = "dense_attention_bwd_rowmajor" if os.environ.get("OFASYS_DENSE_BWD") == "rowmajor" \
        else "dense_attention_bwd"
    for b in batches.values():
        B, Ts, Tt = _task_shapes(b)
        calls = [(Ts, Ts, cfg.encoder.layers), (Tt, Tt, cfg.decoder.layers),
                 (Tt, Ts, cfg.decoder.layers)]
        for Tq, Tk, layers in calls:
            route = _route(cfg, B, Tq, Tk, cfg.attention_dropout)
            if route == "dense":
                n["dense_attention_fwd"] += layers
                n[dense_bwd] += layers
            elif route == "flash":
                n["flash_attention_fwd"] += layers
                n["flash_attention_bwd"] += layers
    if net is not None:
        # B6 (ln_impl): every stack LayerNorm once per task's forward and
        # backward; B6-fwd only where the forward is fused
        from ofasys_torch.ops.layer_norm import FusedLayerNorm

        lns = [m for m in net.modules() if isinstance(m, FusedLayerNorm)]
        n["layer_norm_fwd"] += len(batches) * sum(m.mode == "fused" for m in lns)
        n["layer_norm_bwd"] += len(batches) * len(lns)
    return n


def build_train_model(d, device, arch="base", dtype=torch.bfloat16, ln_impl="xla"):
    """The arch at full width with random weights from SEED; dropout keeps
    its default of 0.1, attention dropout its default of 0."""
    from ofasys_torch import GeneralistModel

    t0 = time.perf_counter()
    model = GeneralistModel(arch=arch, ln_impl=ln_impl)
    model.initialize(d, active_adaptors=ACTIVE_ADAPTORS, dtype=dtype, device=device, seed=SEED)
    cfg = model.cfg
    log(f"train: {arch} arch E={cfg.encoder.embed_dim} ffn={cfg.encoder.ffn_embed_dim} "
        f"heads={cfg.encoder.attention_heads} layers={cfg.encoder.layers}+{cfg.decoder.layers} "
        f"vocab={len(d)} dropout={cfg.dropout} ln_impl={cfg.ln_impl} "
        f"built in {time.perf_counter() - t0:.1f} s")
    return model


def _grads(model, crit, params, step, batches):
    """One update's raw-summed gradients over every task (no optimizer)."""
    from ofasys_torch.engine.train_step import make_grad_step

    total = None
    for i, b in enumerate(batches.values()):
        g, _, _ = make_grad_step(model, crit, fold=i)(params, step, b, SEED)
        total = g if total is None else [a + c for a, c in zip(total, g)]
    return total


def _grad_diff(names, got, ref):
    """|got - ref| / |ref| over all leaves, the relative error of the global
    norm, and {leaf: relative error} for every leaf but the key-side biases
    (NOISE_MODULES)."""
    diff = torch.sqrt(sum(((a - b).float() ** 2).sum() for a, b in zip(got, ref)))
    ref_n = torch.sqrt(sum((b.float() ** 2).sum() for b in ref))
    got_n = torch.sqrt(sum((a.float() ** 2).sum() for a in got))
    leaves = {}
    for name, a, b in zip(names, got, ref):
        path = name.rsplit(".", 2)
        if name.endswith(".bias") and len(path) > 1 and path[-2] in NOISE_MODULES:
            continue
        nb = b.float().norm().item()
        if nb > 0:
            leaves[name] = ((a - b).float().norm() / nb).item()
    return (diff / ref_n).item(), (abs(got_n - ref_n) / ref_n).item(), leaves


def _top_leaves(leaves, n=3):
    return ", ".join(f"{k} {r:.3e}" for k, r in sorted(leaves.items(), key=lambda kv: -kv[1])[:n])


@contextlib.contextmanager
def _dd_from_unrounded_output():
    """Diagnostic: FlashAttentionFunction's backward with dd = rowsum(do * o)
    taken from the output recomputed unrounded (the plain B3 version on the
    same inputs in fp32) instead of the kernel's bf16 output. The change
    enters as an lse cotangent (dd - g_lse), so the kernels run as they are."""
    from ofasys_torch.ops import flash_attention as fl

    cls = fl.FlashAttentionFunction
    orig = cls.__dict__["backward"]

    def backward(ctx, g_out, g_lse):
        q, k, v, bias, mask, out, _ = ctx.saved_tensors
        H, scale, causal = ctx.args
        if g_out is not None:
            o32, _ = fl.flash_attention_fwd_reference(q.float(), k.float(), v.float(), bias, mask, H,
                                                      scale, causal)
            B, Tq, E = q.shape
            corr = (g_out.float() * (o32 - out.float())).reshape(B, Tq, H, E // H).sum(-1)
            corr = corr.permute(0, 2, 1)
            g_lse = -corr if g_lse is None else g_lse.float() - corr
        return orig.__func__(ctx, g_out, g_lse)

    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = orig


def train_and_check(model, gp, card, tasks=None, batches=None, label="train", grad_batches=None,
                    grad_ref=None, n_updates=N_UPDATES):
    """Drive the training path: ``n_updates`` summed multi-task updates
    through make_multitask_train_step, then check what came out; the
    gradient check runs on ``grad_batches`` when given, against the plain
    attention path or, with ``grad_ref``, against that model (another
    ``ln_impl``) at the same parameters. Returns the kernel launch counts of
    that run, its results, and the step, state and batches."""
    from ofasys_torch.configure.configs import OptimizationConfig
    from ofasys_torch.engine.criterion import (
        LabelSmoothedCrossEntropyCriterion,
        LabelSmoothedCrossEntropyCriterionConfig,
    )
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState, make_multitask_train_step
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

    reset_counts()
    outs, times = [], []
    for _ in range(n_updates):
        t0 = time.perf_counter()
        state, out = step(state, dev, SEED)
        _sync(device)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = read_counts()

    losses, gnorms = [], []
    for out in outs:
        tasks_out = out["tasks"].values()
        losses.append(sum(float(t["loss"]) for t in tasks_out)
                      / sum(float(t["sample_size"]) for t in tasks_out))
        gnorms.append(float(out["gnorm"]))
    per_task = {n: [round(float(o["tasks"][n]["loss"]) / float(o["tasks"][n]["sample_size"]), 4)
                    for o in outs] for n in dev}
    log(f"  {label}: loss per token over the {n_updates} updates: {[round(x, 5) for x in losses]}; "
        f"per task {per_task}; gnorm {[round(x, 4) for x in gnorms]}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise SystemExit("a training loss or gnorm is not finite")
    if n_updates > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"the loss did not fall over {n_updates} updates on repeated batches")
    step_ms = statistics.median(times) * 1e3
    n_tokens = sum(int(b["ntokens"]) + _task_shapes(b)[0] * _task_shapes(b)[1]
                   for b in batches.values())
    log(f"  {label}: step time {step_ms:.2f} ms (median of {n_updates}; all "
        f"{[round(t * 1e3, 2) for t in times]}), {n_samples} samples per update = "
        f"{n_samples / (step_ms / 1e3):.1f} samples/s, {n_tokens} source+target tokens per "
        f"update [{card}]")

    per_update = _expected_train_launches(batches, cfg, model.net)
    expected = {n: n_updates * c for n, c in per_update.items()}
    log(f"  {label}: launches {launches} (expected {expected}; per update {per_update})")
    if device.type == "cuda":
        if launches != expected or not any(expected.values()):
            raise SystemExit(f"{label}: a kernel did not run once per attention call of its route")
    else:
        log("  (CPU rehearsal: the plain versions stand in, no launch is counted)")

    # one update's gradients, kernels vs plain attention, dropout 0
    names = [n for n, _ in model.net.named_parameters()]
    gdev = dev if grad_batches is None else {n: sample_to_device(b, device)
                                             for n, b in grad_batches.items()}
    result = dict(step_ms=step_ms, samples_per_s=n_samples / (step_ms / 1e3), losses=losses)
    if grad_ref is not None:
        return launches, {**result, **_grads_vs(model, grad_ref, crit, state, gdev, label)}, \
            (step, state, dev)
    saved = cfg.dropout, cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits
    cfg.dropout = 0.0
    g_plain, g_exact_dd = {}, None
    try:
        g_kernel = _grads(model, crit, state.params, state.step, gdev)
        if per_update["flash_attention_bwd"]:
            with _dd_from_unrounded_output():
                g_exact_dd = _grads(model, crit, state.params, state.step, gdev)
        cfg.attn_kernel, cfg.use_flash_attention = "xla", False
        for logits in GRAD_PLAIN_LOGITS:
            cfg.attn_logits = logits
            g_plain[logits] = _grads(model, crit, state.params, state.step, gdev)
    finally:
        cfg.dropout, cfg.attn_kernel, cfg.use_flash_attention, cfg.attn_logits = saved
    n_grad = sum(b['nsentences'] for b in (grad_batches or batches).values())
    cmp = {logits: _grad_diff(names, g_kernel, g) for logits, g in g_plain.items()}
    for logits, (rel_l, norm_l, leaves) in cmp.items():
        log(f"  {label}: gradients of one update on {n_grad} samples, kernels vs plain attention "
            f"with attn_logits={logits!r} (dropout 0): |g_kernel - g_plain| / |g_plain| {rel_l:.3e}, "
            f"global norm rel err {norm_l:.3e}, worst leaves {_top_leaves(leaves)}")
    worst_c = max(cmp["compute"][2], key=cmp["compute"][2].get)
    _, _, own = _grad_diff(names, g_plain["compute"], g_plain["fp32"])
    log(f"  {label}: plain 'compute' vs plain 'fp32' logits: at {worst_c} {own[worst_c]:.3e}; "
        f"worst leaves {_top_leaves(own)}")
    if g_exact_dd is not None:
        rel_d, _, dleaves = _grad_diff(names, g_exact_dd, g_plain[GRAD_REF_LOGITS])
        log(f"  {label}: the kernels with dd from the unrounded (fp32) output vs plain "
            f"attn_logits={GRAD_REF_LOGITS!r}: rel {rel_d:.3e}, at {worst_c} {dleaves[worst_c]:.3e}, "
            f"worst leaves {_top_leaves(dleaves)} (tol {DD_LEAF_TOL})")
        if not max(dleaves.values()) <= DD_LEAF_TOL:
            raise SystemExit(f"{label}: with dd from the unrounded output a gradient leaf still "
                             "disagrees with the plain attention path")
    rel, norm_rel, leaves = cmp[GRAD_REF_LOGITS]
    worst_name = max(leaves, key=leaves.get)
    worst = leaves[worst_name]
    log(f"  {label}: checked against attn_logits={GRAD_REF_LOGITS!r}: rel {rel:.3e} "
        f"(tol {GRAD_REL_TOL}), worst leaf {worst_name} {worst:.3e} (tol {LEAF_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not worst <= LEAF_REL_TOL:
        raise SystemExit(f"{label}: gradients under the kernels disagree with the plain attention path")
    return launches, dict(**result, grad_rel=rel, grad_norm_rel=norm_rel,
                          grad_worst_leaf=worst, grad_worst_leaf_name=worst_name,
                          grad_by_logits={lg: dict(rel=r, worst=max(lv.values()),
                                                   worst_leaf=max(lv, key=lv.get))
                                          for lg, (r, _, lv) in cmp.items()}), (step, state, dev)


def _grads_vs(model, ref, crit, state, batches, label):
    """One update's gradients (dropout 0) of ``model`` against ``ref``, a
    model of another ln_impl given the same parameters, both with the
    attention kernels: GRAD_REL_TOL over all leaves, LEAF_REL_TOL per leaf
    (the key-side biases left out, as in the train phase)."""
    names = [n for n, _ in model.net.named_parameters()]
    with torch.no_grad():
        for p, q in zip(ref.net.parameters(), state.params, strict=True):
            p.copy_(q)
    saved = model.cfg.dropout, ref.cfg.dropout
    model.cfg.dropout = ref.cfg.dropout = 0.0
    try:
        got = _grads(model, crit, state.params, state.step, batches)
        want = _grads(ref, crit, list(ref.net.parameters()), state.step, batches)
    finally:
        model.cfg.dropout, ref.cfg.dropout = saved
    rel, norm_rel, leaves = _grad_diff(names, got, want)
    worst_name = max(leaves, key=leaves.get)
    log(f"  {label}: gradients of one update vs ln_impl={ref.cfg.ln_impl!r} at the same parameters "
        f"(dropout 0): rel {rel:.3e} (tol {GRAD_REL_TOL}), global norm rel err {norm_rel:.3e}, "
        f"worst leaves {_top_leaves(leaves)} (tol {LEAF_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not leaves[worst_name] <= LEAF_REL_TOL:
        raise SystemExit(f"{label}: gradients disagree with ln_impl={ref.cfg.ln_impl!r}")
    return dict(grad_rel=rel, grad_norm_rel=norm_rel, grad_worst_leaf=leaves[worst_name],
                grad_worst_leaf_name=worst_name)


def phase_profile_train(step, state, batches, card,
                        what="one training update (text_infilling B=128 + gigaword B=64)"):
    """One training update under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches, SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _report_profile(prof, wall_ms, what, card)


def _kernel_entry(name, launches, main_path, rows, err_key, nominal, card, **extra):
    """One kernel's entry of the ``{"kernels": [...]}`` line: ``launches`` by
    path (the counts of each path's run), the error over every checked
    shape, and the times at the ``nominal`` shape."""
    replaces, source = KERNELS[name]
    row = next(r for r in rows if r["shape"] == nominal)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[main_path],
        "launches_by_path": {p: c for p, c in launches.items() if c},
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
    t_start = time.perf_counter()
    name, card = phase_device()
    phase_build()
    hub = build_base_hub()
    cfg, d = hub.model.cfg, hub.global_dict
    train_batches = make_train_batches(hub.general_preprocess)
    long_gp = long_preprocess(d)
    long_batches = make_train_batches(long_gp, LONG_TRAIN_TASKS)
    long_calls = train_shapes(long_batches)
    routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in long_calls}
    log(f"train_long attention routes: {routes}")
    mm_batches = make_train_batches(hub.general_preprocess, MM_TRAIN_TASKS)
    mm_calls = [c for c in train_shapes(mm_batches) if not c[0].startswith("text_infilling")]
    mm_routes = {label: _route(cfg, B, Tq, Tk) for label, (B, Tq, Tk), _ in mm_calls}
    log(f"train_mm attention routes (caption, vqa): {mm_routes}")
    caption_serve = planned_dispatch_shapes(hub.general_preprocess, _caption_requests(), CAPTION_TPL)
    dispatches = [(f"dispatch{i}", s) for i, s in enumerate(planned_dispatch_shapes())] \
        + [(f"serve_caption_dispatch{i}", s) for i, s in enumerate(caption_serve)]
    fres, bres, rres = phase_kernels(
        dispatches, train_shapes(train_batches) + [c for c in long_calls if routes[c[0]] == "dense"]
        + [c for c in mm_calls if mm_routes[c[0]] == "dense"])
    long_serve = planned_dispatch_shapes(long_gp, _long_requests(), SUMMARY_TPL)
    flash_serve = [(f"serve_long_dispatch{i}", s) for i, s in enumerate(long_serve)]
    flash_serve.append(("serve_truncated", planned_dispatch_shapes(
        hub.general_preprocess, _truncated_requests(), SUMMARY_TPL)[0]))
    flash_rows = phase_flash_kernels(flash_serve, [c for c in long_calls if routes[c[0]] == "flash"])
    int8_rows = phase_int8_kernels(max(B * T for B, T in planned_dispatch_shapes()), len(d))
    ln_rows = phase_ln_kernels(train_batches)

    serve_res = serve_and_check(hub, card)
    counts = {"serve": serve_res["launches"]}
    phase_profile(hub, card)
    counts["serve_long"] = serve_long_and_check(hub, card)["launches"]
    counts["serve_truncated"] = serve_truncated_and_check(hub, card)["launches"]
    counts["serve_int8"] = serve_int8_and_check(hub, card, serve_res)["launches"]
    counts["serve_ln"] = serve_ln_and_check(hub, card)["launches"]
    counts["serve_caption"] = serve_caption_and_check(hub, card, serve_res)["launches"]
    phase_profile(hub, card, tpl=CAPTION_TPL, reqs=_caption_requests(),
                  what="one caption dispatch (B=8, beam 5)")

    model = build_train_model(d, "cuda")
    counts["train"], train_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, batches=train_batches)
    phase_profile_train(step, state, dev, card)
    del model, step, state, dev
    torch.cuda.empty_cache()

    model = build_train_model(d, "cuda")
    grad_batches = make_train_batches(long_gp, {n: dict(spec, batch=GRAD_CHECK_BATCH)
                                                for n, spec in LONG_TRAIN_TASKS.items()})
    counts["train_long"], long_res, (step, state, dev) = train_and_check(
        model, long_gp, card, batches=long_batches, label="train_long", grad_batches=grad_batches)
    from ofasys_torch.ops import flash_attention as fl

    old = [n for n in FLASH_BWD_ROWS if hasattr(getattr(fl, n), "launches")]
    log(f"train_long: {counts['train_long']['flash_attention_bwd'] // N_UPDATES} launches of the one "
        f"flash backward pass per update; the part wrappers {list(FLASH_BWD_ROWS)} launch no kernel "
        f"of their own (counted: {old})")
    if old:
        raise SystemExit(f"{old} count launches of their own: the one pass is counted once")
    phase_profile_train(step, state, dev, card,
                        "one long training update (text_infilling_long B=16 + gigaword_long B=16)")
    del model, step, state, dev
    torch.cuda.empty_cache()

    ln = train_ln_and_check(d, hub.general_preprocess, card, batches=train_batches)
    for label, (c, res) in ln.items():
        counts[label] = c
        log(f"{label}: step {res['step_ms']:.2f} ms, {res['samples_per_s']:.1f} samples/s "
            f"(train: {train_res['step_ms']:.2f} ms, {train_res['samples_per_s']:.1f} samples/s) [{card}]")

    model = build_train_model(d, "cuda")
    counts["train_mm"], mm_res, (step, state, dev) = train_and_check(
        model, hub.general_preprocess, card, batches=mm_batches, label="train_mm")
    phase_profile_train(step, state, dev, card,
                        "one three-task update (caption B=64 + text_infilling B=128 + vqa B=48)")
    del model, step, state, dev
    torch.cuda.empty_cache()
    counts["train_rowmajor"], row_res = train_rowmajor_and_check(
        d, hub.general_preprocess, card, batches=mm_batches, mm_res=mm_res)
    torch.cuda.empty_cache()

    def by_path(kernel):
        return {path: c[kernel] for path, c in counts.items()}

    kernels = [
        _kernel_entry("dense_attention_fwd", by_path("dense_attention_fwd"), "train", fres, "err_out",
                      "text_infilling_encoder", card,
                      max_abs_err_lse=max(r["err_lse"] for r in fres)),
        _kernel_entry("dense_attention_bwd", by_path("dense_attention_bwd"), "train", bres, "err",
                      "text_infilling_encoder", card),
        _kernel_entry("dense_attention_bwd_rowmajor", by_path("dense_attention_bwd_rowmajor"),
                      "train_rowmajor", rres, "err", "caption_encoder", card),
        _kernel_entry("flash_attention_fwd", by_path("flash_attention_fwd"), "train_long",
                      flash_rows["flash_attention_fwd"], "err", "gigaword_long_encoder", card,
                      max_abs_err_lse=max(r["err_lse"] for r in flash_rows["flash_attention_fwd"])),
    ] + [
        dict(_kernel_entry("flash_attention_bwd", by_path("flash_attention_bwd"), "train_long",
                           flash_rows["flash_attention_bwd"], err_key, "gigaword_long_encoder",
                           card, port="flash_attention_bwd",
                           ms_covers="the whole backward (dq, dk, dv, bias gradient) in one pass",
                           plain_covers="the whole backward (dq, dk, dv, bias gradient)",
                           library_covers="the whole backward (dq, dk, dv, bias gradient)"),
             name=name, replaces=replaces)
        for name, (replaces, err_key) in FLASH_BWD_ROWS.items()
    ] + [
        _kernel_entry("int8_matmul_fwd", by_path("int8_matmul_fwd"), "serve_int8", int8_rows, "err",
                      "decode_logits", card, bit_equal=all(r["bit_equal"] for r in int8_rows),
                      library_covers="torch._int_mm + the same epilogue"),
    ] + [
        _kernel_entry(k, by_path(k), "train_ln", ln_rows[k], "err", "text_infilling_encoder", card)
        for k in ("layer_norm_fwd", "layer_norm_bwd")
    ]
    log(f"train: {json.dumps(train_res)}")
    log(f"train_long: {json.dumps(long_res)}")
    log(f"train_mm: {json.dumps(mm_res)}")
    log(f"train_rowmajor: {json.dumps(row_res)}")
    for label, (_, res) in ln.items():
        log(f"{label}: {json.dumps(res)}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
