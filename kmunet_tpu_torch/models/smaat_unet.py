"""SmaAt-UNet baseline (port of ``kmunet_tpu/models/smaat_unet.py``): a
depthwise-separable UNet with CBAM attention on every skip.

Depthwise-separable double convs (``kernels_per_layer`` 2), CBAM (channel
and spatial attention, a BatchNorm in the spatial gate) on the five encoder
levels, 4 max-pool downs and 4 align-corners bilinear ups, a 1x1 head.
Takes (B, H, W, frames) and returns (B, H, W, n_classes) as the JAX model
does; NCHW inside. Submodules carry the flax names (``DoubleConvDS_0`` ..
``_8``, ``CBAM_0`` .. ``_4``, ``outc``). ``model.train()`` switches the
BatchNorms to flax's training semantics (``nn.layers.batch_norm``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.layers import batch_norm
from kmunet_tpu_torch.ops.sample import resize_bilinear


def _bn(channels: int) -> nn.BatchNorm2d:
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``."""
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class DepthwiseSeparableConv(nn.Module):
    """A 3x3 depthwise conv of ``kernels_per_layer`` filters per channel,
    then a 1x1 pointwise conv."""

    def __init__(self, in_channels: int, features: int, kernels_per_layer: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_channels, in_channels * kernels_per_layer, 3, padding=1,
                                   groups=in_channels)
        self.pointwise = nn.Conv2d(in_channels * kernels_per_layer, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class DoubleConvDS(nn.Module):
    """(depthwise-separable conv, BatchNorm, ReLU) twice."""

    def __init__(self, in_channels: int, features: int, mid_features: Optional[int] = None,
                 kernels_per_layer: int = 1):
        super().__init__()
        mid = mid_features or features
        self.DepthwiseSeparableConv_0 = DepthwiseSeparableConv(in_channels, mid, kernels_per_layer)
        self.BatchNorm_0 = _bn(mid)
        self.DepthwiseSeparableConv_1 = DepthwiseSeparableConv(mid, features, kernels_per_layer)
        self.BatchNorm_1 = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm(self.DepthwiseSeparableConv_0(x), self.BatchNorm_0))
        return F.relu(batch_norm(self.DepthwiseSeparableConv_1(x), self.BatchNorm_1))


class CBAM(nn.Module):
    """Channel attention (a shared two-layer MLP over the average- and
    max-pooled descriptors), then spatial attention (a bias-free 7x7 conv
    and a BatchNorm over the channel mean and max)."""

    def __init__(self, channels: int, reduction_ratio: int = 16, kernel_size: int = 7):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction_ratio)
        self.Dense_1 = nn.Linear(channels // reduction_ratio, channels)
        self.Conv_0 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)
        self.BatchNorm_0 = _bn(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(t):
            return self.Dense_1(F.relu(self.Dense_0(t)))

        gate = torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))
        x = x * gate[:, :, None, None]
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(batch_norm(self.Conv_0(s), self.BatchNorm_0))


class SmaAt_UNet(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, n_classes); H and W multiples of
    16 (four 2x2 poolings)."""

    def __init__(self, n_classes: int = 20, kernels_per_layer: int = 2, reduction_ratio: int = 16,
                 in_channels: int = 5):
        super().__init__()
        kpl, rr = kernels_per_layer, reduction_ratio
        enc = (64, 128, 256, 512, 512)  # the last is 1024 // factor(2)
        cin = in_channels
        for i, c in enumerate(enc):
            setattr(self, f"DoubleConvDS_{i}", DoubleConvDS(cin, c, kernels_per_layer=kpl))
            setattr(self, f"CBAM_{i}", CBAM(c, rr))
            cin = c
        # up(x1, x2, c): cat([skip, upsampled]) -> DoubleConvDS(c, mid = in // 2)
        for i, (skip, c) in enumerate(zip((512, 256, 128, 64), (256, 128, 64, 64)), 5):
            cat = skip + cin
            setattr(self, f"DoubleConvDS_{i}", DoubleConvDS(cat, c, mid_features=cat // 2,
                                                            kernels_per_layer=kpl))
            cin = c
        self.outc = nn.Conv2d(cin, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(5):
            if i:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"DoubleConvDS_{i}")(x)
            skips.append(getattr(self, f"CBAM_{i}")(x))
        y = skips.pop()
        for i in range(5, 9):
            H, W = y.shape[2:]
            y = resize_bilinear(y, (2 * H, 2 * W), align_corners=True)
            y = getattr(self, f"DoubleConvDS_{i}")(torch.cat([skips.pop(), y], 1))
        return self.outc(y).permute(0, 2, 3, 1)
