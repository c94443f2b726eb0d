"""DySample upsampler and deformable conv (port of ``kmunet_tpu/nn/resample.py``).

DySample runs the dense window formulation (``ops/sample.py``), the JAX
package's default, or with ``window=False`` the exact path through the K4
grouped gather; the deformable conv samples its 9 taps in one call of the
K7 multiview gather (the taps as its views). Where the image rows are
sharded (``parallel/halo.py``) each rank computes its block of output
rows: the window path reads a halo of rows, and the gathers read the whole
source, gathered from every rank, at coordinates in the global image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_, normal_
from kmunet_tpu_torch.ops.sample import (
    bilinear_gather_grouped,
    bilinear_gather_multiview,
    dysample_window_upsample,
)
from kmunet_tpu_torch.parallel.halo import all_gather_rows, row_axis, row_range

DYSAMPLE_WINDOW_RADIUS = 2


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW pixel shuffle, (B, C*r^2, H, W) -> (B, C, rH, rW): output
    (c, r*h+i, r*w+j) is input channel c*r^2 + i*r + j, the JAX package's
    channel order (NHWC there)."""
    return F.pixel_shuffle(x, r)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of ``pixel_shuffle``: (B, C, rH, rW) -> (B, C*r^2, H, W)."""
    return F.pixel_unshuffle(x, r)


class DySample(nn.Module):
    """Content-aware upsampling by learned sampling offsets (NCHW).

    A 1x1 conv (``offset``) predicts per-group, per-subpixel (x, y) offsets,
    times 0.25 or, with ``dyscope``, times sigmoid(``scope``(x)) * 0.5 (a
    bias-free 1x1 conv, zero init); they are added to the static subpixel
    grid and the source is sampled bilinearly with border clamping.
    ``style="lp"`` runs the offset conv on x (channels laid out
    (g, di, dj, [x, y])); ``style="pl"`` runs it on ``pixel_shuffle(x)``
    with 2g channels (g, [x, y]), unshuffled to (g, [x, y], di, dj).

    ``window=True`` (the default, as in the JAX package) samples through the
    dense window formulation, exact while |subpixel init + offset| < r;
    ``window=False`` takes the exact path: the sampling coordinates
    ``j + 0.5 + init + offset - 0.5`` are built in x's dtype in the JAX
    package's order, cast to fp32 only for the grouped gather (K4 on a CUDA
    tensor), and their gradient flows back through the cast in their own
    dtype.
    """

    def __init__(self, channels: int, scale: int = 2, style: str = "lp", groups: int = 4,
                 dyscope: bool = False, window: bool = True):
        super().__init__()
        if style not in ("lp", "pl"):
            raise ValueError(f"style must be 'lp' or 'pl', got {style!r}")
        if channels < groups or channels % groups:
            raise ValueError(f"channels {channels} must be a multiple of groups {groups}")
        if style == "pl" and channels % (scale * scale):
            raise ValueError(f"style 'pl' needs channels {channels} divisible by {scale}^2")
        self.scale = scale
        self.style = style
        self.groups = groups
        self.window = window
        c_in, c_out = (channels, 2 * groups * scale * scale) if style == "lp" else (
            channels // (scale * scale), 2 * groups)
        self.offset = nn.Conv2d(c_in, c_out, 1)
        self.scope = nn.Conv2d(c_in, c_out, 1, bias=False) if dyscope else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        normal_(self.offset.weight, generator, std=1e-3)
        self.offset.bias.zero_()
        if self.scope is not None:
            self.scope.weight.zero_()

    def _offsets(self, x: torch.Tensor):
        """offx, offy (B, g, s(di), s(dj), H, W) in x's dtype."""
        B, C, H, W = x.shape
        s, g = self.scale, self.groups
        src = pixel_shuffle(x, s) if self.style == "pl" else x
        raw = self.offset(src)
        if self.scope is not None:
            raw = raw * torch.sigmoid(self.scope(src)) * 0.5
        else:
            raw = raw * 0.25
        if self.style == "pl":
            off = pixel_unshuffle(raw, s).reshape(B, g, 2, s, s, H, W)
            return off[:, :, 0], off[:, :, 1]
        off = raw.reshape(B, g, s, s, 2, H, W)
        return off[:, :, :, :, 0], off[:, :, :, :, 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        s, g = self.scale, self.groups
        offx, offy = self._offsets(x)
        # Static subpixel positions relative to the cell: (d - (s-1)/2) / s.
        sub = (torch.arange(s, dtype=x.dtype, device=x.device) - (s - 1) / 2.0) / s
        init_x = sub.view(1, 1, 1, s, 1, 1)  # varies with dj
        init_y = sub.view(1, 1, s, 1, 1, 1)  # varies with di
        axis = row_axis()
        if self.window:
            return dysample_window_upsample(x, init_x + offx, init_y + offy,
                                            radius=DYSAMPLE_WINDOW_RADIUS)
        row0, _ = row_range(axis, H)
        jj = torch.arange(W, dtype=x.dtype, device=x.device).view(1, 1, 1, 1, 1, W)
        ii = torch.arange(row0, row0 + H, dtype=x.dtype, device=x.device)
        ii = ii.view(1, 1, 1, 1, H, 1)
        px = jj + 0.5 + init_x + offx  # (B, g, di, dj, H, W)
        py = ii + 0.5 + init_y + offy
        # Output pixel (s*i+di, s*j+dj) of group g samples at (py, px) - 0.5:
        # (B, g, di, dj, H, W) -> (B, g, H, di, W, dj) -> (B, g, sH, sW).
        xs = (px - 0.5).permute(0, 1, 4, 2, 5, 3).reshape(B, g, s * H, s * W)
        ys = (py - 0.5).permute(0, 1, 4, 2, 5, 3).reshape(B, g, s * H, s * W)
        out = bilinear_gather_grouped(all_gather_rows(x, axis).permute(0, 2, 3, 1).contiguous(),
                                      xs.float().contiguous(), ys.float().contiguous(),
                                      padding_mode="border")
        return out.permute(0, 3, 1, 2).contiguous()


class DeformConv2d(nn.Module):
    """torchvision-semantics deformable conv on NHWC tensors, zero padding.

    Tap k = (kh, kw) samples ``x`` at p + (kh - p, kw - p) + offset_k, with
    ``offset`` (B, H, W, 2*k*k) laid out (k, [dy, dx]); the taps are then
    contracted with ``weight`` (F, C, k, k). The sampling coordinates are
    built in ``x``'s dtype (promoted with ``offset``'s), in the JAX package's
    order of additions, and cast to fp32 only for the gather: a bf16 or fp16
    value is exact in fp32, so the gather sees the JAX package's
    coordinates, and their gradient flows back through the cast in their
    own dtype. The k*k taps are the views of one multiview gather, whose
    (B, H, W, k*k*C) output is the JAX package's tap-major concatenation of
    k*k single gathers.
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
        axis = row_axis()
        row0, _ = row_range(axis, H)
        ii = torch.arange(row0, row0 + H, dtype=x.dtype, device=x.device).view(1, 1, H, 1)
        jj = torch.arange(W, dtype=x.dtype, device=x.device).view(1, 1, 1, W)
        tap = torch.arange(k * k, device=x.device)
        dy = (tap // k - p).to(x.dtype).view(1, k * k, 1, 1)  # kh - p of tap kh * k + kw
        dx = (tap % k - p).to(x.dtype).view(1, k * k, 1, 1)  # kw - p
        off = offset.permute(0, 3, 1, 2)  # (B, k*k*[dy, dx], H, W)
        sy = (ii + dy) + off[:, 0::2]  # (B, k*k, H, W)
        sx = (jj + dx) + off[:, 1::2]
        src = all_gather_rows(x, axis, dim=1).contiguous()  # the whole image
        gathered = bilinear_gather_multiview(src, sx.float().contiguous(),
                                             sy.float().contiguous(),
                                             padding_mode="zeros")  # (B, H, W, k*k*C), tap-major
        w = self.weight.permute(2, 3, 1, 0).reshape(k * k * C, -1)
        return gathered @ w + self.bias
