"""SCECA-Net baseline (port of ``kmunet_tpu/models/sceca_net.py``): a UNet
with SCConv feature reconstruction and ECA channel attention on every skip.

SRU (gamma-thresholded channel masks, doubling the channels), CRU (split
group / pointwise convs and an SE gate), ECA (a 1-D conv over the pooled
channels with a log2-adaptive kernel), a DenseLayer bottleneck (growth 32
x 4, dropout 0.5 in training) and a 4-level UNet with align-corners
bilinear ups. Takes (B, H, W, frames) and returns (B, H, W, out_channels);
NCHW inside. flax's GroupNorm takes eps 1e-6, its BatchNorms here 1e-5.

Kept quirks of the reference: SRU's masks are hard thresholds of
``sigmoid(gamma / sum(gamma))``, so gamma's gradient is 0; SRU's GroupNorm
is computed and thrown away, so its parameters exist (and convert) but get
a zero gradient. The port does not compute it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.nn.layers import Dropout, batch_norm
from kmunet_tpu_torch.ops.sample import resize_bilinear


def _conv(cin: int, f: int, k: int, bias: bool = True, groups: int = 1) -> nn.Conv2d:
    """flax ``Conv(f, (k, k), padding='SAME')`` at stride 1 (odd k)."""
    return nn.Conv2d(cin, f, k, padding=k // 2, bias=bias, groups=groups)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class SRU(nn.Module):
    """Spatial reconstruction: x times gamma's binary channel masks and
    their complement, concatenated (C -> 2C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gn = nn.GroupNorm(min(32, channels), channels, eps=1e-6)  # unused, as in JAX
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = torch.sigmoid(self.gamma / self.gamma.sum())
        w1 = (ws > 0.5).to(x.dtype)[:, None, None]
        w2 = (ws <= 0.5).to(x.dtype)[:, None, None]
        return torch.cat([x * w1, x * w2], 1)


class CRU(nn.Module):
    """Channel reconstruction: a 1x1 compress, the upper half through a 3x3
    group conv plus a 1x1, the lower through a 1x1 plus itself, and an SE
    gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        upper = channels // 2
        self.upper = upper
        self.compress = _conv(channels, channels, 1, bias=False)
        self.gwc = _conv(upper, upper, 3, bias=False, groups=upper)
        self.pwc1 = _conv(upper, upper, 1, bias=False)
        self.pwc2 = _conv(channels - upper, channels - upper, 1, bias=False)
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.compress(x)
        xu, xl = x[:, :self.upper], x[:, self.upper:]
        y = torch.cat([self.gwc(xu) + self.pwc1(xu), self.pwc2(xl) + xl], 1)
        a = torch.sigmoid(self.fc2(F.relu(self.fc1(y.mean((2, 3))))))
        return y * a[:, :, None, None]


class ECA(nn.Module):
    """Efficient channel attention: a bias-free 1-D conv of k taps (k the odd
    number at or above ``(log2(C) + b) / gamma``, padding k // 2) over the
    channels' means. ``conv_weight`` (1, 1, k) is flax's ``conv_kernel``
    (k, 1, 1)."""

    def __init__(self, channels: int, gamma: int = 2, b: int = 1):
        super().__init__()
        t = int(abs((math.log2(channels) + b) / gamma))
        k = t if t % 2 else t + 1
        self.conv_weight = nn.Parameter(torch.empty(1, 1, k))

    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.conv_weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.conv_weight.shape[-1]
        y = F.conv1d(x.mean((2, 3))[:, None], self.conv_weight, padding=k // 2)[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


class SCECA(nn.Module):
    """SRU (C -> 2C), CRU, ECA, then a bias-free 1x1 conv back to C."""

    def __init__(self, channels: int):
        super().__init__()
        self.sru = SRU(channels)
        self.cru = CRU(2 * channels)
        self.eca = ECA(2 * channels)
        self.channel_adjust = _conv(2 * channels, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.channel_adjust(self.eca(self.cru(self.sru(x))))


class DenseLayer(nn.Module):
    """Four (BatchNorm, ReLU, bias-free 3x3 conv of ``growth_rate``, dropout)
    layers, each on the concatenation of all before it, then a 1x1
    transition back to C. ``dropout_rate`` is a class attribute, as the JAX
    constructor does not expose it."""

    dropout_rate = 0.5

    def __init__(self, channels: int, growth_rate: int = 32, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            cin = channels + i * growth_rate
            setattr(self, f"BatchNorm_{i}", _bn(cin))
            setattr(self, f"dense{i}", _conv(cin, growth_rate, 3, bias=False))
        self.drop = Dropout(self.dropout_rate)
        self.transition = _conv(channels + num_layers * growth_rate, channels, 1, bias=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = [x]
        for i in range(self.num_layers):
            y = batch_norm(torch.cat(feats, 1), getattr(self, f"BatchNorm_{i}"))
            y = getattr(self, f"dense{i}")(F.relu(y))
            feats.append(self.drop(y, generator))
        return self.transition(torch.cat(feats, 1))


class DoubleConv(nn.Module):
    """(bias-free 3x3 conv, BatchNorm, ReLU) twice."""

    def __init__(self, in_channels: int, features: int, mid: Optional[int] = None):
        super().__init__()
        mid = mid or features
        self.Conv_0 = _conv(in_channels, mid, 3, bias=False)
        self.BatchNorm_0 = _bn(mid)
        self.Conv_1 = _conv(mid, features, 3, bias=False)
        self.BatchNorm_1 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm(self.Conv_0(x), self.BatchNorm_0))
        return F.relu(batch_norm(self.Conv_1(x), self.BatchNorm_1))


class SCECANet(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, out_channels); H and W multiples
    of 2^(levels - 1). In training the forward takes the
    ``torch.Generator`` the bottleneck's dropout draws from."""

    def __init__(self, out_channels: int = 20, features: Sequence[int] = (64, 128, 256, 512),
                 in_channels: int = 5):
        super().__init__()
        feats = list(features)
        self.levels = len(feats)
        cin = in_channels
        for i, f in enumerate(feats):
            setattr(self, f"enc{i}", DoubleConv(cin, f))
            setattr(self, f"sceca{i}", SCECA(f))
            cin = f
        self.dense = DenseLayer(cin)
        for i, f in enumerate(feats[-2::-1]):
            setattr(self, f"dec{i}", DoubleConv(f + cin, f))
            cin = f
        self.output = nn.Conv2d(cin, out_channels, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(self.levels):
            xs = getattr(self, f"sceca{i}")(getattr(self, f"enc{i}")(x))
            skips.append(xs)
            x = F.max_pool2d(xs, 2) if i < self.levels - 1 else xs
        x = self.dense(x, generator)
        skips.reverse()
        for i in range(self.levels - 1):
            H, W = x.shape[2:]
            x = resize_bilinear(x, (2 * H, 2 * W), align_corners=True)
            skip = skips[i + 1]
            if x.shape[2:] != skip.shape[2:]:
                x = resize_bilinear(x, skip.shape[2:], align_corners=True)
            x = getattr(self, f"dec{i}")(torch.cat([skip, x], 1))
        return self.output(x).permute(0, 2, 3, 1)
