"""ResNet trunk for the image adaptor (counterpart of ofasys_tpu/model/resnet.py).

NHWC in and out, as the flax module. Parameters keep flax's names and
layouts, so utils/jax_params.py carries them as they are: each convolution
holds ``kernel`` (kh, kw, Cin, Cout), each norm ``scale``, ``bias``,
``mean`` and ``var``. A convolution runs ``F.conv2d`` on the NHWC input seen
as a channels-last NCHW tensor, with the kernel permuted to (Cout, Cin, kh,
kw) in channels-last memory: bf16 operands from fp32 parameters (flax's
``nn.Conv(dtype=bf16, param_dtype=fp32)``), flax's explicit symmetric
padding of k // 2.

Normalization is FrozenBatchNorm with stored statistics. As in ofasys_tpu,
``mean`` and ``var`` are parameters, not buffers: they take gradients and
optimizer updates like the affine ones.

Only the first 3 stages run (output stride 16, 1,024 channels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ofasys_torch.ops.attention import dropout

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6),
    "resnet101": (3, 4, 23),
    "resnet152": (3, 8, 36),
}
STAGE_FEATURES = (64, 128, 256)
EXPANSION = 4
BN_EPS = 1e-5


class Conv2d(nn.Module):
    """flax ``nn.Conv`` without bias: (k, k) window, stride s, padding k // 2
    on each side, kernel (k, k, Cin, Cout) in fp32, compute in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.kernel = nn.Parameter(torch.zeros(k, k, cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (B, H, W, Cin)
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, stride=self.stride, padding=self.k // 2)
        return y.permute(0, 2, 3, 1)                          # (B, H', W', Cout)


class FrozenBatchNorm(nn.Module):
    """y = (x - mean) / sqrt(var + eps) * scale + bias with stored stats:
    ``inv = scale * rsqrt(var + eps)`` in fp32, then ``x * inv + (bias -
    mean * inv)`` with both factors cast to x's dtype."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.scale * torch.rsqrt(self.var + self.eps)
        return x * inv.to(x.dtype) + (self.bias - self.mean * inv).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = features * EXPANSION
        self.drop_path_rate = drop_path_rate
        self.conv1 = Conv2d(cin, features, 1, 1, dtype)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride, dtype)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = Conv2d(features, out, 1, 1, dtype)
        self.bn3 = FrozenBatchNorm(out)
        self.has_downsample = cin != out or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, out, 1, stride, dtype)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        # stochastic depth: one keep draw per sample on the residual branch
        y = dropout(y, self.drop_path_rate, generator, shape=(y.shape[0], 1, 1, 1))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """3-stage ResNet trunk: (B, H, W, 3) NHWC in [-1, 1]-ish normalized
    space -> (B, H/16, W/16, 1024). ``generator`` turns on drop_path."""

    def __init__(self, resnet_type: str = "resnet50", drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if resnet_type not in STAGE_BLOCKS:
            raise ValueError(f"unknown resnet_type {resnet_type!r}; available: {sorted(STAGE_BLOCKS)}")
        self.conv1 = Conv2d(3, 64, 7, 2, dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.block_names = []
        cin = 64
        for stage, (feats, n) in enumerate(zip(STAGE_FEATURES, STAGE_BLOCKS[resnet_type])):
            for i in range(n):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, Bottleneck(cin, feats, stride, drop_path_rate, dtype))
                self.block_names.append(name)
                cin = feats * EXPANSION

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        # 3 x 3, stride 2, padded with -inf
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, generator)
        return x


def init_resnet_(module: nn.Module, generator: torch.Generator):
    """flax's initializers: lecun-normal (truncated) conv kernels over the
    fan-in k * k * Cin; unit scale and var, zero bias and mean."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                k, _, cin, _ = m.kernel.shape
                std = float(np.sqrt(1.0 / (k * k * cin))) / 0.87962566103423978
                nn.init.trunc_normal_(m.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            elif isinstance(m, FrozenBatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
