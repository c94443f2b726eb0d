"""Intelligent Wavelet Pooling (port of ``kmunet_tpu/nn/wavelet.py``), NCHW."""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.ops.dwt import haar_dwt2d
from kmunet_tpu_torch.parallel.halo import row_axis


class IntelligentWaveletPooling(nn.Module):
    """2x downsampling: Haar DWT, the high bands weighted by a "softmax" over
    one channel (identically 1.0, a reference quirk kept as computed) and
    averaged, fused with LL by a 1x1 conv. On sharded rows (an even count
    per rank) the DWT is local; the reference's zeroed last row is the
    global one's, on the last rank."""

    def __init__(self, channels: int):
        super().__init__()
        self.high_freq_conv = nn.Conv2d(3 * channels, 1, 1)
        self.fusion_conv = nn.Conv2d(channels + 1, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = row_axis()
        LL, LH, HL, HH = haar_dwt2d(x, last_rows=axis is None or axis.index == axis.size - 1)
        high = torch.cat([LH, HL, HH], dim=1)
        attention = torch.softmax(self.high_freq_conv(high), dim=1)
        hf_avg = (high * attention).mean(dim=1, keepdim=True)
        return self.fusion_conv(torch.cat([LL, hf_avg], dim=1))
