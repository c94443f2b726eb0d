"""Intelligent Wavelet Pooling (port of ``kmunet_tpu/nn/wavelet.py``), NCHW."""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.ops.dwt import haar_dwt2d


class IntelligentWaveletPooling(nn.Module):
    """2x downsampling: Haar DWT, the high bands weighted by a "softmax" over
    one channel (identically 1.0, a reference quirk kept as computed) and
    averaged, fused with LL by a 1x1 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.high_freq_conv = nn.Conv2d(3 * channels, 1, 1)
        self.fusion_conv = nn.Conv2d(channels + 1, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        LL, LH, HL, HH = haar_dwt2d(x)
        high = torch.cat([LH, HL, HH], dim=1)
        attention = torch.softmax(self.high_freq_conv(high), dim=1)
        hf_avg = (high * attention).mean(dim=1, keepdim=True)
        return self.fusion_conv(torch.cat([LL, hf_avg], dim=1))
