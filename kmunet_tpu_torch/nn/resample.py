"""DySample upsampler and deformable conv (port of ``kmunet_tpu/nn/resample.py``).

DySample runs the dense window formulation (``ops/sample.py``), the JAX
package's default; the deformable conv samples its 9 taps through the K5
bilinear gather.
"""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_, normal_
from kmunet_tpu_torch.ops.sample import bilinear_gather, dysample_window_upsample

DYSAMPLE_WINDOW_RADIUS = 2


class DySample(nn.Module):
    """Content-aware 'lp' upsampling: a 1x1 conv predicts per-group,
    per-subpixel (x, y) offsets, times 0.25, added to the static subpixel
    grid; the source is sampled bilinearly with border clamping.

    The offset conv's channels are laid out (g, di, dj, [x, y]).
    """

    def __init__(self, channels: int, scale: int = 2, groups: int = 4):
        super().__init__()
        if channels < groups or channels % groups:
            raise ValueError(f"channels {channels} must be a multiple of groups {groups}")
        self.scale = scale
        self.groups = groups
        self.offset = nn.Conv2d(channels, 2 * groups * scale * scale, 1)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        normal_(self.offset.weight, generator, std=1e-3)
        self.offset.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        s, g = self.scale, self.groups
        off = (self.offset(x) * 0.25).reshape(B, g, s, s, 2, H, W)
        # Static subpixel positions relative to the cell: (d - (s-1)/2) / s.
        sub = (torch.arange(s, dtype=x.dtype, device=x.device) - (s - 1) / 2.0) / s
        ex = sub.view(1, 1, 1, s, 1, 1) + off[:, :, :, :, 0]  # varies with dj
        ey = sub.view(1, 1, s, 1, 1, 1) + off[:, :, :, :, 1]  # varies with di
        return dysample_window_upsample(x, ex, ey, radius=DYSAMPLE_WINDOW_RADIUS)


class DeformConv2d(nn.Module):
    """torchvision-semantics deformable conv on NHWC tensors, zero padding.

    Tap k = (kh, kw) samples ``x`` at p + (kh - p, kw - p) + offset_k, with
    ``offset`` (B, H, W, 2*k*k) laid out (k, [dy, dx]); the taps are then
    contracted with ``weight`` (F, C, k, k). The sampling coordinates are
    built in ``x``'s dtype (promoted with ``offset``'s), in the JAX package's
    order of additions, and cast to fp32 only for the gather: a bf16 or fp16
    value is exact in fp32, so the gather sees the JAX package's
    coordinates, and their gradient flows back through the cast in their
    own dtype.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        k, p = self.kernel_size, self.padding
        if offset.shape[-1] != 2 * k * k:
            raise ValueError(f"offset needs {2 * k * k} channels, got {offset.shape[-1]}")
        x = x.contiguous()
        ii = torch.arange(H, dtype=x.dtype, device=x.device).view(1, H, 1)
        jj = torch.arange(W, dtype=x.dtype, device=x.device).view(1, 1, W)
        taps = []
        for kh in range(k):
            for kw in range(k):
                t = kh * k + kw
                sy = (ii + (kh - p)) + offset[..., 2 * t]
                sx = (jj + (kw - p)) + offset[..., 2 * t + 1]
                taps.append(bilinear_gather(x, sx.float().contiguous(), sy.float().contiguous(),
                                            padding_mode="zeros"))
        gathered = torch.cat(taps, dim=-1)  # (B, H, W, k*k*C), tap-major
        w = self.weight.permute(2, 3, 1, 0).reshape(k * k * C, -1)
        return gathered @ w + self.bias
