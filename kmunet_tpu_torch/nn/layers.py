"""Basic blocks (port of ``kmunet_tpu/nn/layers.py``), NCHW."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis (dim 1) of an NCHW or (B, C, L) tensor:
    biased variance, per-channel affine ``weight`` and ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)


def same_padding(kernel_size) -> tuple[int, int]:
    """Symmetric padding of flax's ``padding='SAME'`` at stride 1, odd kernels."""
    kh, kw = kernel_size
    return kh // 2, kw // 2


class ConvBNAct(nn.Module):
    """Bias-free conv, eval-mode BatchNorm (eps 1e-5), optional activation.

    ``bn_weight_init`` is the initial BN scale (0 makes a residual branch
    start as the identity).
    """

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3), groups: int = 1,
                 bn_weight_init: float = 1.0, act: Optional[Callable] = F.relu):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size,
                                padding=same_padding(kernel_size), groups=groups, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        nn.init.constant_(self.BatchNorm_0.weight, bn_weight_init)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return self.act(x) if self.act is not None else x


class FFN(nn.Module):
    """1x1 conv MLP: expand (BN + ReLU), then project (BN scale init 0)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(channels, hidden, (1, 1))
        self.ConvBNAct_1 = ConvBNAct(hidden, channels, (1, 1), act=None, bn_weight_init=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class DropPath(nn.Module):
    """Stochastic depth over the batch axis; the identity in eval mode, the
    only mode the port serves."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("the port serves eval mode only")
        return x
