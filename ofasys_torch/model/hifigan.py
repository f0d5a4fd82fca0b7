"""HiFi-GAN V1 generator, the vocoder of TTS mel output (counterpart of
ofasys_tpu/model/hifigan.py; reference ofasys/module/hifigan.py:115).

conv_pre -> [transposed-conv upsample -> multi-receptive-field fusion
(parallel dilated residual conv stacks, averaged)] x 4 -> conv_post ->
tanh. Modules keep ofasys_tpu's flax names (``conv_pre``, ``ups_{i}``,
``resblocks_{i}_{j}/convs{1,2}_{k}``, ``conv_post``), so
``utils/jax_params.load_jax_params`` carries its tree in: a Conv kernel
(k, in, out) becomes the ``nn.Conv1d`` weight (out, in, k), and a
ConvTranspose kernel, which ``hifigan_to_flax_params`` flipped along k,
is flipped back into the ``nn.ConvTranspose1d`` weight (in, out, k).

flax's SAME-padded ConvTranspose with the flipped kernel equals torch's
``ConvTranspose1d(k, r, padding=(k - r) // 2)`` only for even k - r: an
odd one raises. Run in fp32 (``HifiGanVocoder``); Griffin-Lim stays the
audio preprocessor's default, as in ofasys_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.utils.device import resolve_device


@dataclass
class HifiGanConfig:
    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ResBlock1(nn.Module):
    """x + convs2_i(lrelu(convs1_i(lrelu(x)))) for each dilation; (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", nn.Conv1d(channels, channels, kernel_size, dilation=d,
                                                     padding=(kernel_size - 1) * d // 2))
            self.add_module(f"convs2_{i}", nn.Conv1d(channels, channels, kernel_size,
                                                     padding=(kernel_size - 1) // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(lrelu(x))
            x = x + getattr(self, f"convs2_{i}")(lrelu(h))
        return x


class HifiGanGenerator(nn.Module):
    def __init__(self, cfg: Optional[HifiGanConfig] = None):
        super().__init__()
        self.cfg = cfg = cfg or HifiGanConfig()
        self.conv_pre = nn.Conv1d(cfg.num_mels, cfg.upsample_initial_channel, 7, padding=3)
        ch = cfg.upsample_initial_channel
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            # flax's SAME padding only matches for even k - rate: fail loudly
            assert (k - rate) % 2 == 0, (
                f"upsample stage {i}: kernel {k} - rate {rate} must be even "
                f"for ConvTranspose SAME-padding parity with torch"
            )
            out = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"ups_{i}", nn.ConvTranspose1d(ch, out, k, stride=rate,
                                                           padding=(k - rate) // 2))
            ch = out
            for j, (ks, ds) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}", ResBlock1(ch, ks, ds))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, num_mels) log-mel -> (B, T * prod(rates)) waveform."""
        cfg = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))
        n = len(cfg.resblock_kernel_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(lrelu(x))
            acc = None
            for j in range(n):
                h = getattr(self, f"resblocks_{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / n
        # the last activation's slope is F.leaky_relu's default 0.01, not 0.1
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


def init_hifigan_(model: HifiGanGenerator, generator: torch.Generator) -> HifiGanGenerator:
    """HiFi-GAN's own init (normal, std 0.01, for every convolution; zero
    biases), drawn from ``generator`` in parameter order."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.01)
            else:
                p.zero_()
    return model


class HifiGanVocoder:
    """Mel frames to waveforms on ``device``, in fp32, with weights from
    ``weights_path``: a HiFi-GAN torch checkpoint (``.pt``, ``.ckpt``,
    ``.pth``, weight-norm pairs fused by ``hifigan_to_flax_params``), an
    ``.npz`` of a converted flax tree, or none (random weights from
    ``seed``)."""

    def __init__(self, cfg: Optional[HifiGanConfig] = None, weights_path: Optional[str] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        from ofasys_torch.utils.jax_params import load_jax_params

        self.cfg = cfg or HifiGanConfig()
        self.device = resolve_device(device)
        self.model = HifiGanGenerator(self.cfg)
        if weights_path and weights_path.endswith((".pt", ".ckpt", ".pth")):
            from ofasys_torch.utils.torch_import import hifigan_to_flax_params, load_torch_checkpoint

            load_jax_params(self.model, hifigan_to_flax_params(
                load_torch_checkpoint(weights_path), num_kernels=len(self.cfg.resblock_kernel_sizes)))
        elif weights_path:
            import pickle

            with np.load(weights_path, allow_pickle=True) as data:
                load_jax_params(self.model, pickle.loads(data["params"].tobytes()))
        else:
            init_hifigan_(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.cfg.upsample_rates))

    @torch.no_grad()
    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """(T, num_mels) or (B, T, num_mels) -> waveform(s)."""
        squeeze = mel.ndim == 2
        m = torch.as_tensor(np.asarray(mel[None] if squeeze else mel, np.float32), device=self.device)
        wav = self.model(m).cpu().numpy()
        return wav[0] if squeeze else wav
