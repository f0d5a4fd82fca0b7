"""GumbelVQ VQGAN for discrete image tokens (counterpart of
ofasys_tpu/model/vqgan.py).

256 x 256 RGB -> a 32 x 32 grid of codes from an 8,192-entry codebook
(f8), and back: the structure of taming-transformers' released
``vqgan_gumbel_f8_8192``. ``encoder`` -> ``quant_conv`` (z_channels ->
embed_dim, 1 x 1) -> ``quant_proj`` (codebook logits) -> hard argmax;
decoding goes ``codebook`` -> ``post_quant_proj`` (embed_dim ->
z_channels) -> ``decoder``. GroupNorm(32, eps 1e-6), swish, and an
AttnBlock (1 x 1 convolutions and ``torch.matmul`` products) at the
``attn_resolutions`` and in the mid stack. The encoder's Downsample pads
asymmetrically ((0, 1), (0, 1)) before a stride-2 convolution; the decoder
upsamples by nearest neighbour.

Layout is NCHW, the convolutions ``nn.Conv2d`` (OIHW weights) and the
norms ``nn.GroupNorm``; module names follow ofasys_tpu's flax tree, so
``utils/jax_params.load_jax_params`` maps a flax VQGAN tree onto it (HWIO
kernels to OIHW, GroupNorm ``scale`` to ``weight``), and
``utils/torch_import.taming_to_flax_params`` maps a taming state_dict onto
that tree. Codes come from a hard argmax of the logits (the noiseless
path): taming's GumbelQuantize adds Gumbel noise even in eval mode, so
tokens against the real taming tokenizer are approximate by design.

:class:`VQGANTokenizer` is the host-facing wrapper on an explicit
``device`` (CUDA by default; raises where CUDA is absent).
"""

from __future__ import annotations

import math
import pickle
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.utils.device import resolve_device


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = _conv(cin, cout, 3, pad=1)
        self.norm2 = _norm(cout)
        self.conv2 = _conv(cout, cout, 3, pad=1)
        self.nin_shortcut = _conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = _conv(channels, channels, 1)
        self.k = _conv(channels, channels, 1)
        self.v = _conv(channels, channels, 1)
        self.proj_out = _conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, C, H * W).transpose(1, 2)        # (B, HW, C)
        k = self.k(h).reshape(B, C, H * W)                         # (B, C, HW)
        v = self.v(h).reshape(B, C, H * W).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k) / math.sqrt(C), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class VqganEncoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 4), num_res_blocks: int = 2,
                 z_channels: int = 256, resolution: int = 256, attn_resolutions: Sequence[int] = (32,)):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = _conv(3, ch, 3, pad=1)
        res, cin = resolution, ch
        self.attn_levels = set()
        for i, m in enumerate(self.ch_mult):
            for j in range(num_res_blocks):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(cin, ch * m))
                cin = ch * m
                if res in attn_resolutions:
                    self.add_module(f"down_{i}_attn_{j}", AttnBlock(cin))
                    self.attn_levels.add(i)
            if i != len(self.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", _conv(cin, cin, 3, stride=2))
                res //= 2
        self.mid_block_1 = ResnetBlock(cin, cin)
        self.mid_attn = AttnBlock(cin)
        self.mid_block_2 = ResnetBlock(cin, cin)
        self.norm_out = _norm(cin)
        self.conv_out = _conv(cin, z_channels, 3, pad=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(len(self.ch_mult)):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
                if i in self.attn_levels:
                    h = getattr(self, f"down_{i}_attn_{j}")(h)
            if i != len(self.ch_mult) - 1:
                # taming's Downsample: zero pad (0, 1) x (0, 1), then a VALID stride-2 conv
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(swish(self.norm_out(h)))


class VqganDecoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 4), num_res_blocks: int = 2,
                 z_channels: int = 256, resolution: int = 256, attn_resolutions: Sequence[int] = (32,)):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        cin = ch * self.ch_mult[-1]
        self.conv_in = _conv(z_channels, cin, 3, pad=1)
        self.mid_block_1 = ResnetBlock(cin, cin)
        self.mid_attn = AttnBlock(cin)
        self.mid_block_2 = ResnetBlock(cin, cin)
        res = resolution // 2 ** (len(self.ch_mult) - 1)
        self.attn_levels = set()
        for i, m in reversed(list(enumerate(self.ch_mult))):
            for j in range(num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(cin, ch * m))
                cin = ch * m
                if res in attn_resolutions:
                    self.add_module(f"up_{i}_attn_{j}", AttnBlock(cin))
                    self.attn_levels.add(i)
            if i != 0:
                self.add_module(f"up_{i}_upsample", _conv(cin, cin, 3, pad=1))
                res *= 2
        self.norm_out = _norm(cin)
        self.conv_out = _conv(cin, 3, 3, pad=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(z))))
        for i in reversed(range(len(self.ch_mult))):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
                if i in self.attn_levels:
                    h = getattr(self, f"up_{i}_attn_{j}")(h)
            if i != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(swish(self.norm_out(h)))


class GumbelVQ(nn.Module):
    def __init__(self, n_embed: int = 8192, embed_dim: int = 256, z_channels: int = 256,
                 ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 4), num_res_blocks: int = 2,
                 resolution: int = 256, attn_resolutions: Sequence[int] = (32,)):
        super().__init__()
        kw = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks, z_channels=z_channels,
                  resolution=resolution, attn_resolutions=attn_resolutions)
        self.ch_mult = tuple(ch_mult)
        self.encoder = VqganEncoder(**kw)
        self.decoder = VqganDecoder(**kw)
        self.quant_conv = _conv(z_channels, embed_dim, 1)
        self.quant_proj = _conv(embed_dim, n_embed, 1)
        self.codebook = nn.Embedding(n_embed, embed_dim)
        self.post_quant_proj = _conv(embed_dim, z_channels, 1)

    def code_logits(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> (B, h, w, n_embed) codebook logits."""
        z = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        return self.quant_proj(z).permute(0, 2, 3, 1)

    def encode_codes(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> (B, h * w) int64 codes (hard argmax),
        row-major over the grid."""
        codes = torch.argmax(self.code_logits(images), dim=-1)
        return codes.reshape(codes.shape[0], -1)

    def decode_codes(self, codes: torch.Tensor, grid: Optional[int] = None) -> torch.Tensor:
        """(B, h * w) codes -> (B, H, W, 3) images in [-1, 1]."""
        B, n = codes.shape
        g = grid or int(round(math.sqrt(n)))
        z = self.codebook(codes.reshape(B, g, g)).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_proj(z)).permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.decode_codes(self.encode_codes(images))


def init_vqgan_(model: GumbelVQ, generator: torch.Generator):
    """flax's initializers: lecun-normal (truncated) convolution kernels
    with zero bias, unit GroupNorms, and a normal(0, 1 / sqrt(embed_dim))
    codebook."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        model.codebook.weight.normal_(0.0, model.codebook.weight.shape[1] ** -0.5, generator=generator)


class VQGANTokenizer:
    """Images to codes and back on ``device``, with weights from
    ``weights_path``: a taming torch checkpoint (``.pt``, ``.ckpt``,
    ``.pth``; mapped through ``taming_to_flax_params``), an ``.npz`` of a
    converted flax tree, or none (random weights from ``seed``)."""

    def __init__(self, code_image_size: int = 256, n_embed: int = 8192,
                 weights_path: Optional[str] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda", **vq_kwargs):
        from ofasys_torch.utils.jax_params import load_jax_params

        self.device = resolve_device(device)
        self.code_image_size = code_image_size
        self.model = GumbelVQ(n_embed=n_embed, resolution=code_image_size, **vq_kwargs)
        if weights_path and weights_path.endswith((".pt", ".ckpt", ".pth")):
            from ofasys_torch.utils.torch_import import load_torch_checkpoint, taming_to_flax_params

            load_jax_params(self.model, taming_to_flax_params(load_torch_checkpoint(weights_path)))
        elif weights_path:
            with np.load(weights_path, allow_pickle=True) as data:
                tree = pickle.loads(data["params"].tobytes()) if "params" in data else dict(data)
            load_jax_params(self.model, tree)
        else:
            init_vqgan_(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    def to(self, device: Union[str, torch.device]) -> "VQGANTokenizer":
        self.device = resolve_device(device)
        self.model.to(self.device)
        return self

    @property
    def codes_per_image(self) -> int:
        down = 2 ** (len(self.model.ch_mult) - 1)
        return (self.code_image_size // down) ** 2

    @torch.no_grad()
    def encode(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) float in [0, 1] -> (B, n_codes) int32."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device) * 2.0 - 1.0
        return self.model.encode_codes(x).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """codes -> (B, H, W, 3) float in [0, 1]."""
        img = self.model.decode_codes(torch.as_tensor(np.asarray(codes), dtype=torch.long,
                                                      device=self.device))
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
