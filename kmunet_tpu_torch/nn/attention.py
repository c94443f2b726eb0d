"""Attention and normalisation blocks of KM_UNetV3 (port of
``kmunet_tpu/nn/attention.py``), NCHW. Where the image rows are sharded
(``parallel/halo.py``) the means and GroupNorms span the global image and
the convs taller than a row read their neighbours' rows."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.parallel.halo import conv2d, group_norm, spatial_mean


class ChannelAttention(nn.Module):
    """SE gate: GAP -> Linear/SiLU/Linear/sigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.Dense_1(F.silu(self.Dense_0(spatial_mean(x)))))
        return x * y[:, :, None, None]


class LocalContrastAttention(nn.Module):
    """SE on the channel means averaged over groups of ``reduction_ratio``
    consecutive channels; the gate blends the input toward 1: x*(1-g) + g."""

    def __init__(self, channels: int, reduction_ratio: int = 4):
        super().__init__()
        self.reduction_ratio = reduction_ratio
        self.Dense_0 = nn.Linear(channels // reduction_ratio, 64)
        self.Dense_1 = nn.Linear(64, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        avg = spatial_mean(x).reshape(B, C // self.reduction_ratio, self.reduction_ratio)
        g = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(avg.mean(-1)))))[:, :, None, None]
        return x * (1.0 - g) + g


class TripleNorm(nn.Module):
    """Mean of two GroupNorm(1)s (the reference's "height" and "width" norms,
    each with its own affine) and a LayerNorm over C."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm_h = nn.GroupNorm(1, channels, eps=1e-5)
        self.norm_w = nn.GroupNorm(1, channels, eps=1e-5)
        self.norm_c = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.norm_c(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return (group_norm(self.norm_h, x) + group_norm(self.norm_w, x) + c) / 3.0


class MultiScaleFusion(nn.Module):
    """3/5/7-kernel branches (conv -> GroupNorm(1) -> SiLU), concatenated,
    1x1 and 3x3 convs, then channel attention. ``channels`` lists each
    branch's input channels; every branch projects to ``channels[-1]``."""

    def __init__(self, channels, reduction: int = 4):
        super().__init__()
        out_c = channels[-1]
        for i, (c, s) in enumerate(zip(channels, (3, 5, 7))):
            setattr(self, f"branch{i}", nn.Conv2d(c, out_c, s, padding=s // 2))
            setattr(self, f"GroupNorm_{i}", nn.GroupNorm(1, out_c, eps=1e-5))
        self.Conv_0 = nn.Conv2d(len(channels) * out_c, out_c, 1)
        self.Conv_1 = nn.Conv2d(out_c, out_c, 3, padding=1)
        self.ChannelAttention_0 = ChannelAttention(out_c, reduction)

    def forward(self, features) -> torch.Tensor:
        branches = [
            F.silu(group_norm(getattr(self, f"GroupNorm_{i}"),
                              conv2d(getattr(self, f"branch{i}"), f)))
            for i, f in enumerate(features)
        ]
        fused = conv2d(self.Conv_1, self.Conv_0(torch.cat(branches, dim=1)))
        return self.ChannelAttention_0(fused)


class DirectionAttention(nn.Module):
    """sigmoid(q*k)*v through a depthwise 3x3, scaled by a gate computed from
    the global channel means (every mode pools to the same (B, C))."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // 4)
        self.Dense_1 = nn.Linear(channels // 4, channels)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.Dense_1(F.gelu(self.Dense_0(spatial_mean(x)))))
        q, k, v = self.qkv(x).chunk(3, dim=1)
        attn = conv2d(self.conv, torch.sigmoid(q * k) * v)
        return attn * w[:, :, None, None]
