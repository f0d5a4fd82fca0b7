"""Plain PyTorch reference of the OFA encoder-decoder, in float32.

Written from the published model (OFA, arXiv:2202.03052; its unified
pre-LN Transformer with NormFormer extras, absolute and bucketed relative
position biases, a ResNet trunk for images) and the parameter names the
benchmark hands it; it imports nothing of the program. It runs one request
or a few samples at a time, with explicit attention (softmax of the scaled
products plus the biases), so that it fits beside nothing else on the card.

Inputs are the benchmark's: the weights it made from the seed (a dict of
name -> float32 tensor), token ids, uint8 images. Everything derived from
them (bucket matrices, position biases, the prompt's bytes) is worked out
here again.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import buckets

LN_EPS = 1e-5
BN_EPS = 1e-5
TOKEN_BUCKETS = 256
IMAGE_BUCKETS = 42
ATTN_SCALE_FACTOR = 2.0
RESNET_BLOCKS = {"resnet50": (3, 4, 6), "resnet101": (3, 4, 23), "resnet152": (3, 8, 36)}


def no_tf32():
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ln(p, name, x):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], LN_EPS)


def _lin(p, name, x):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


class Reference:
    """``params``: name -> float32 tensor on one device. ``cfg``: the
    configuration file's sizes. ``keep_scale``: the divisor of kept values
    under dropout (the keep probability as the configuration's compute
    dtype rounds it)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, pad: int, keep_scale: float = 0.9):
        self.p = params
        self.cfg = cfg
        self.pad = pad
        self.keep_scale = keep_scale
        self.E = cfg["encoder_embed_dim"]
        self.max_pos = cfg["max_source_positions"]

    # ----------------------------------------------------------- helpers
    def _attention(self, pre, q_in, kv_in, heads, bias, key_keep, causal):
        p = self.p
        B, Tq, E = q_in.shape
        Tk = kv_in.shape[1]
        D = E // heads
        scaling = (D * ATTN_SCALE_FACTOR) ** -0.5
        q = (_lin(p, pre + ".q_proj", q_in) * scaling).view(B, Tq, heads, D).transpose(1, 2)
        k = _lin(p, pre + ".k_proj", kv_in).view(B, Tk, heads, D).transpose(1, 2)
        v = _lin(p, pre + ".v_proj", kv_in).view(B, Tk, heads, D).transpose(1, 2)
        s = q @ k.transpose(-1, -2)
        if bias is not None:
            s = s + bias
        keep = key_keep[:, None, None, :]
        if causal:
            keep = keep & torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()[None, None]
        s = s.masked_fill(~keep, float("-inf"))
        o = torch.softmax(s, dim=-1) @ v                                  # (B, H, Tq, D)
        o = o * p[pre + ".c_attn"][None, :, None, None]
        return _lin(p, pre + ".out_proj", o.transpose(1, 2).reshape(B, Tq, E))

    def _ffn(self, pre, x):
        h = F.gelu(_lin(self.p, pre + ".fc1", x))
        h = _ln(self.p, pre + ".fc2_ln", h)
        return _lin(self.p, pre + ".fc2", h)

    def _drop(self, x, masks):
        if masks is None:
            return x
        return torch.where(next(masks), x / self.keep_scale, torch.zeros((), device=x.device))

    def _abs_bias(self, side, pos, heads):
        """(1, H, T, T) from the layer-normed position embeddings."""
        E = pos.shape[-1]
        scaling = (E / heads * ATTN_SCALE_FACTOR) ** -0.5
        q = (_lin(self.p, side + ".pos_q_linear", pos) * scaling).view(1, -1, heads, E // heads)
        k = _lin(self.p, side + ".pos_k_linear", pos).view(1, -1, heads, E // heads)
        return q.transpose(1, 2) @ k.permute(0, 2, 3, 1)

    # ------------------------------------------------------------- image
    def resnet(self, pre, x):
        """The trunk's first three stages on NCHW float32 images."""
        p = self.p

        def conv(name, x, stride):
            w = p[name + ".kernel"].permute(3, 2, 0, 1)
            return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

        def bn(name, x):
            inv = p[name + ".scale"] / torch.sqrt(p[name + ".var"] + BN_EPS)
            return x * inv[None, :, None, None] + (p[name + ".bias"] - p[name + ".mean"] * inv)[None, :, None, None]

        x = F.relu(bn(pre + ".bn1", conv(pre + ".conv1", x, 2)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage, n in enumerate(RESNET_BLOCKS[self.cfg["resnet_type"]]):
            for i in range(n):
                b = f"{pre}.layer{stage + 1}_{i}"
                stride = 2 if (i == 0 and stage > 0) else 1
                y = F.relu(bn(b + ".bn1", conv(b + ".conv1", x, 1)))
                y = F.relu(bn(b + ".bn2", conv(b + ".conv2", y, stride)))
                y = bn(b + ".bn3", conv(b + ".conv3", y, 1))
                if b + ".downsample_conv.kernel" in p:
                    x = bn(b + ".downsample_bn", conv(b + ".downsample_conv", x, stride))
                x = F.relu(y + x)
        return x

    def image_slot(self, images_u8: torch.Tensor):
        """uint8 (B, S, S, 3) -> embeddings (B, h*w, E), position embeddings
        (1, h*w, E), the bucket (h*w, h*w) and the per-layer table."""
        pre = "encoder_adaptor.image_resnet"
        x = (images_u8.float() / 255.0 - 0.5) / 0.5
        feat = self.resnet(pre + ".embed_images", x.permute(0, 3, 1, 2))
        B, C, h, w = feat.shape
        emb = _lin(self.p, pre + ".image_proj", feat.permute(0, 2, 3, 1).reshape(B, h * w, C))
        ids = buckets.grid_positions(h, w, IMAGE_BUCKETS)
        pos = self.p[pre + ".embed_image_positions.weight"][torch.as_tensor(ids, device=emb.device)][None]
        bucket = buckets.image_bucket(h, w, IMAGE_BUCKETS)
        return emb, pos, bucket, self.p[pre + ".image_rel_pos_table"], pre

    def text_slot(self, side: str, ids: torch.Tensor):
        """(B, T) ids -> embeddings, position embeddings (1, T, E), bucket, table."""
        pre = f"{side}_adaptor.text"
        T = ids.shape[1]
        emb = self.p["embed_tokens.weight"][ids]
        pos = self.p[pre + ".embed_positions.weight"][:T][None]
        bucket = buckets.token_bucket(TOKEN_BUCKETS, self.max_pos, T)
        return emb, pos, bucket, self.p[pre + ".rel_pos_table"], pre

    def _adapt(self, slot, is_src, masks=None):
        emb, pos, bucket, table, pre = slot
        if is_src:
            emb = emb + self.p[pre + ".type_embedding"]
        emb = _ln(self.p, pre + ".layernorm_embedding", emb)
        pos = _ln(self.p, pre + ".layernorm_position", pos)
        return self._drop(emb, masks), pos, bucket, table

    @staticmethod
    def _rel_bias(parts, layer, heads, device):
        """The block-diagonal relative bias of layer ``layer``: each slot's
        own table gathered at its bucket, zero across slots."""
        T = sum(b.shape[0] for _, _, b, _ in parts)
        out = torch.zeros(1, heads, T, T, device=device)
        o = 0
        for _, _, bucket, table in parts:
            n = bucket.shape[0]
            idx = torch.as_tensor(bucket, dtype=torch.long, device=device)
            out[0, :, o:o + n, o:o + n] = table[layer][idx].permute(2, 0, 1)
            o += n
        return out

    # ----------------------------------------------------------- forward
    def encode(self, src_ids: torch.Tensor, images_u8: Optional[torch.Tensor] = None, masks=None):
        """(B, T) source ids (pad-padded) and optional images ahead of them
        -> (x, key_keep, pos) of the encoder."""
        cfg, p = self.cfg, self.p
        H, L = cfg["encoder_attention_heads"], cfg["encoder_layers"]
        parts = []
        if images_u8 is not None:
            parts.append(self._adapt(self.image_slot(images_u8), True, masks))
        parts.append(self._adapt(self.text_slot("encoder", src_ids), True, masks))
        B = src_ids.shape[0]
        x = torch.cat([e.expand(B, -1, -1) for e, _, _, _ in parts], dim=1)
        pos = torch.cat([q for _, q, _, _ in parts], dim=1)
        keep = torch.cat([torch.ones(B, e.shape[1], dtype=torch.bool, device=x.device)
                          for e, _, _, _ in parts[:-1]] + [src_ids != self.pad], dim=1)
        abs_bias = self._abs_bias("encoder_adaptor", pos, H)
        for i in range(L):
            pre = f"encoder.layers_{i}"
            bias = abs_bias + self._rel_bias(parts, i, H, x.device)
            h = self._attention(pre + ".self_attn", _ln(p, pre + ".self_attn_layer_norm", x),
                                _ln(p, pre + ".self_attn_layer_norm", x), H, bias, keep, False)
            x = x + self._drop(_ln(p, pre + ".attn_ln", h), masks)
            h = self._ffn(pre + ".ffn", _ln(p, pre + ".final_layer_norm", x))
            x = x + self._drop(h, masks)
        return _ln(p, "encoder.layer_norm", x), keep, pos

    def decode(self, prev: torch.Tensor, enc, masks=None):
        """Teacher-forced decoder over (B, T) previous tokens -> float32
        logits (B, T, V)."""
        cfg, p = self.cfg, self.p
        H, L = cfg["decoder_attention_heads"], cfg["decoder_layers"]
        enc_x, enc_keep, enc_pos = enc
        x, pos, bucket, table = self._adapt(self.text_slot("decoder", prev), False, masks)
        keep = prev != self.pad
        abs_bias = self._abs_bias("decoder_adaptor", pos, H)
        E = x.shape[-1]
        scaling = (E / H * ATTN_SCALE_FACTOR) ** -0.5
        cq = (_lin(p, "cross_pos_q_linear", pos) * scaling).view(1, -1, H, E // H).transpose(1, 2)
        ck = _lin(p, "cross_pos_k_linear", enc_pos).view(1, -1, H, E // H).permute(0, 2, 3, 1)
        cross_bias = cq @ ck
        for i in range(L):
            pre = f"decoder.layers_{i}"
            bias = abs_bias + self._rel_bias([(None, None, bucket, table)], i, H, x.device)
            h = _ln(p, pre + ".self_attn_layer_norm", x)
            h = self._attention(pre + ".self_attn", h, h, H, bias, keep, True)
            x = x + self._drop(_ln(p, pre + ".self_attn_ln", h), masks)
            h = self._attention(pre + ".encoder_attn", _ln(p, pre + ".encoder_attn_layer_norm", x),
                                enc_x, H, cross_bias, enc_keep, False)
            x = x + self._drop(_ln(p, pre + ".cross_attn_ln", h), masks)
            h = self._ffn(pre + ".ffn", _ln(p, pre + ".final_layer_norm", x))
            x = x + self._drop(h, masks)
        x = _ln(p, "decoder.layer_norm", x)
        return x @ p["embed_tokens.weight"].t()


def label_smoothed_loss(logits: torch.Tensor, target: torch.Tensor, pad: int, eps: float):
    """Summed label-smoothed cross entropy over the non-pad targets (the
    smoothing mass spread over the V - 1 other tokens) and their count."""
    V = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, target[..., None])[..., 0]
    smooth = -lp.sum(-1)
    eps_i = eps / (V - 1)
    loss = (1.0 - eps - eps_i) * nll + eps_i * smooth
    valid = target != pad
    return torch.where(valid, loss, torch.zeros((), device=loss.device)).sum(), valid.sum()


class AdamW:
    """AdamW after global-norm clipping (at ``clip``, with no epsilon: the
    gradients are scaled by clip / |g| where |g| >= clip), bias-corrected
    moments, ``eps`` outside the root, decoupled weight decay, constant
    learning rate."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float, weight_decay: float, clip: float):
        self.lr, self.b1, self.b2, self.eps, self.wd, self.clip = lr, b1, b2, eps, weight_decay, clip
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        self.t += 1
        bc1 = 1.0 - float(np.float32(self.b1) ** np.float32(self.t))
        bc2 = 1.0 - float(np.float32(self.b2) ** np.float32(self.t))
        for name, g in grads.items():
            g = g * scale
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * params[name]
            params[name].add_(upd * -self.lr)
        return norm


def byte_prompt(text_start: int, piece: str) -> List[int]:
    """A template's literal text as the byte-level tokenizer gives it: the
    UTF-8 bytes of one leading space and the stripped text."""
    return [text_start + b for b in (" " + piece.strip()).encode("utf-8")]


def gather_logprobs(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """log-softmax of (T, V) logits at each position's token."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp[torch.arange(len(tokens), device=lp.device), torch.as_tensor(tokens, device=lp.device)]
