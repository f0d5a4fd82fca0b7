"""The yardstick's arithmetic: the H100's published peaks, the model FLOPs
of an update or a dispatch worked out from shapes, and the roofline bound
of an attention kernel call.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its
full 700 W limit. The attention bounds are those of ``chip_smoke.py``'s
``_flash_bounds`` and ``_bound``, frozen here: each input read once, each
output written once; 2·B·H·Tq·Tk·D FLOP per (Tq, Tk, D) product, two in the
forward (q·k, p·v), five in the backward.
"""

from __future__ import annotations

from typing import Dict, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# the ResNet trunk's first three stages (the image adaptor's): blocks per stage
RESNET_STAGE_BLOCKS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23), "resnet152": (3, 8, 36)}
RESNET_STAGE_FEATURES = (64, 128, 256)
RESNET_EXPANSION = 4


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes over the memory
    rate and its FLOP over the bf16 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def flash_fwd_cost(B: int, Tq: int, Tk: int, H: int, D: int, nb: int, out32: bool = False):
    """(bytes, FLOP) of one flash forward call (B3) without a causal mask:
    q, k, v, the bf16 bias of ``nb`` heads and the key mask read once; the
    output (and its fp32 copy with ``out32``) and the lse written once."""
    E = H * D
    qkv = 2 * (B * Tq * E + 2 * B * Tk * E)
    n_bytes = qkv + 2 * nb * Tq * Tk + B * Tk + (6 if out32 else 2) * B * Tq * E + 4 * B * H * Tq
    return n_bytes, 4 * B * H * Tq * Tk * D


def flash_bwd_cost(B: int, Tq: int, Tk: int, H: int, D: int, nb: int):
    """(bytes, FLOP) of one flash backward pass (dq, dk, dv and the bias
    gradient) without a causal mask: q, k, v, do, lse, dd, bias and mask
    read once; dq, dk, dv and the fp32 bias gradient written once."""
    E = H * D
    qkv = 2 * (B * Tq * E + 2 * B * Tk * E)
    reads = qkv + 2 * B * Tq * E + 8 * B * H * Tq + 2 * nb * Tq * Tk + B * Tk
    writes = 2 * (B * Tq * E + 2 * B * Tk * E) + 4 * nb * Tq * Tk
    return reads + writes, 10 * B * H * Tq * Tk * D


def resnet_flops(resnet_type: str, size: int) -> int:
    """Forward FLOP of the trunk (stem, then the three stages of
    bottlenecks) on one ``size`` x ``size`` image."""
    s = (size + 1) // 2
    flops = 2 * s * s * 7 * 7 * 3 * 64
    s = (s + 1) // 2                          # the stem's max pool
    cin = 64
    for stage, (feats, n) in enumerate(zip(RESNET_STAGE_FEATURES, RESNET_STAGE_BLOCKS[resnet_type])):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            out = feats * RESNET_EXPANSION
            s_out = (s + stride - 1) // stride
            flops += 2 * s * s * cin * feats                 # 1x1 reduce
            flops += 2 * s_out * s_out * 9 * feats * feats    # 3x3
            flops += 2 * s_out * s_out * feats * out          # 1x1 expand
            if cin != out or stride != 1:
                flops += 2 * s_out * s_out * cin * out        # downsample
            cin, s = out, s_out
    return flops


def encoder_flops(cfg: Dict, lengths: Sequence[int]) -> int:
    """Forward FLOP of the encoder stack over samples of these lengths:
    the dense products of every token and the two attention products."""
    E, F, L = cfg["encoder_embed_dim"], cfg["encoder_ffn_embed_dim"], cfg["encoder_layers"]
    dense = 2 * (4 * E * E + 2 * E * F)
    return sum(L * (dense * t + 4 * t * t * E) for t in lengths)


def decoder_flops(cfg: Dict, vocab: int, pairs: Sequence) -> int:
    """Forward FLOP of the decoder stack and the tied output projection over
    (target length, source length) pairs, the whole target at once: the
    dense products of every target token (self q/k/v/out, cross q/out, the
    FFN), cross k/v over the source, the attention products (self causal:
    halved) and the logits."""
    E, F, L = cfg["decoder_embed_dim"], cfg["decoder_ffn_embed_dim"], cfg["decoder_layers"]
    per_tok = 2 * (6 * E * E + 2 * E * F)
    total = 0
    for t, s in pairs:
        self_attn = 2 * t * t * E
        total += L * (per_tok * t + 2 * 2 * E * E * s + self_attn + 4 * t * s * E) + 2 * E * vocab * t
    return int(total)


def train_update_flops(cfg: Dict, vocab: int, samples: Sequence) -> int:
    """Model FLOP of one update (forward and backward: three times the
    forward) over (source length, target length) of its samples' real
    tokens."""
    fwd = encoder_flops(cfg, [s for s, _ in samples])
    fwd += decoder_flops(cfg, vocab, [(t, s) for s, t in samples])
    return 3 * fwd


def decode_flops(cfg: Dict, vocab: int, n: int, beams: int, steps: int, src: int) -> int:
    """Forward FLOP of beam decoding ``n`` requests: cross k/v over the
    source once a request, then at step i every beam's token through the
    decoder with i + 1 cached positions, and its logits."""
    E, F, L = cfg["decoder_embed_dim"], cfg["decoder_ffn_embed_dim"], cfg["decoder_layers"]
    per_tok = 2 * (6 * E * E + 2 * E * F) + 2 * E * vocab / L
    total = n * L * 2 * 2 * E * E * src
    for i in range(steps):
        total += n * beams * L * (per_tok + 4 * (i + 1) * E + 4 * src * E)
    return int(total)


def serve_dispatch_flops(cfg: Dict, vocab: int, n: int, image_size: int, src: int, beams: int,
                         steps: int) -> int:
    """Model FLOP of one dispatch of ``n`` requests: the trunk on each image
    and its projection to the model width, the encoder over ``src`` tokens,
    and the decode."""
    f = 0
    if image_size:
        grid = (image_size // 16) ** 2
        f += n * (resnet_flops(cfg["resnet_type"], image_size) + 2 * 1024 * cfg["encoder_embed_dim"] * grid)
    f += encoder_flops(cfg, [src] * n)
    return f + decode_flops(cfg, vocab, n, beams, steps, src)
