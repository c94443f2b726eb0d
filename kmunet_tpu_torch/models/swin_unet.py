"""Swin-UNet baseline (port of ``kmunet_tpu/models/swin_unet.py``): a
shifted-window transformer U-Net.

swin-tiny as the reference loads it: patch 4, embed 96, depths (2, 2, 2,
2), heads (3, 6, 12, 24), window 8, MLP ratio 4, stochastic depth 0.2;
windowed attention with a relative-position bias and, in every second
block, the shifted windows' mask; PatchMerging downs, PatchExpand ups with
a linear skip fusion (``concat_back_dim``), a final 4x patch expand and a
bias-free 1x1 head. Takes (B, H, W, frames) and returns (B, H, W,
num_classes); the blocks work on (B, H, W, C) token maps, NCHW only at the
two convs. flax's LayerNorms take eps 1e-6.

Each block clamps its window to ``min(window, H, W)`` of the map it sees
and drops the shift where the window covers the map, and its bias table is
sized from that window, so the parameter shapes follow the input size:
``img_size`` fixes it at construction, as flax's init fixes it at the first
call. The decoder reuses the encoder's depths reversed, as the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import truncated_normal_
from kmunet_tpu_torch.nn.layers import DropPath

EPS = 1e-6


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, C)


def window_reverse(windows: torch.Tensor, w: int, H: int, W: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    B = windows.shape[0] // ((H // w) * (W // w))
    x = windows.reshape(B, H // w, W // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


def relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w): the bias table's row of each (query, key) pair of a window."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]


def shift_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask of the shifted windows: -100 between
    pixels of different regions of the rolled map, else 0."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Multi-head attention within each window, with a learned bias per
    relative offset (``relative_position_bias_table``, ((2w-1)^2, heads))
    and the shift's mask."""

    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("index", torch.from_numpy(relative_position_index(window)).reshape(-1),
                             persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bw, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(Bw, N, 3, h, C // h).permute(2, 0, 3, 1, 4).unbind(0)
        bias = self.relative_position_bias_table[self.index].reshape(N, N, h).permute(2, 0, 1)
        bias = bias[None].to(q.dtype)
        if mask is not None:
            nW = mask.shape[0]
            bias = (bias.expand(Bw // nW, nW, h, N, N) + mask[None, :, None].to(q.dtype)).reshape(
                Bw, h, N, N)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(out.transpose(1, 2).reshape(Bw, N, C))


class SwinBlock(nn.Module):
    """(Shifted) window attention and an MLP, each pre-LN with a residual
    through stochastic depth, on a (B, H, W, C) map of ``resolution``."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, resolution,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        H, W = resolution
        self.window = min(window, H, W)
        self.shift = shift if self.window < min(H, W) else 0
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, self.window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.drop_path = DropPath(drop_path)
        mask = shift_mask(H, W, self.window, self.shift) if self.shift else np.zeros((0,))
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = window_reverse(self.attn(window_partition(y, w), self.mask if s else None), w, H, W)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + self.drop_path(y, generator)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + self.drop_path(y, generator)


class PatchMerging(nn.Module):
    """2x2 neighbours to channels (the reference's [x0, x1, x2, x3] order),
    LayerNorm, a bias-free linear 4C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class PatchExpand(nn.Module):
    """A bias-free linear C -> ``scale``^2 C / ``shrink``, a ``scale`` x
    ``scale`` pixel shuffle, LayerNorm: ``PatchExpand`` is scale 2 and
    shrink 2 (C -> C/2), ``FinalPatchExpandX4`` scale 4 and shrink 1."""

    def __init__(self, dim: int, scale: int = 2, shrink: int = 2):
        super().__init__()
        self.scale, self.out = scale, dim // shrink
        self.expand = nn.Linear(dim, scale * scale * self.out, bias=False)
        self.norm = nn.LayerNorm(self.out, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        r, c = self.scale, self.out
        x = self.expand(x).reshape(B, H, W, r, r, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, r * H, r * W, c))



class SwinUNet(nn.Module):
    """(B, img_size, img_size, in_channels) -> (B, img_size, img_size,
    num_classes). In training the forward takes the ``torch.Generator`` its
    stochastic depth draws from."""

    def __init__(self, num_classes: int = 20, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 8, mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 in_channels: int = 5, img_size: int = 256):
        super().__init__()
        n = len(depths)
        self.depths = list(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        rgb = 3 if in_channels == 1 else in_channels  # one channel is tiled to three
        self.patch_embed = nn.Conv2d(rgb, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=EPS)
        res = img_size // patch_size

        def blocks(prefix, level):
            dim, r = embed_dim * 2 ** level, res // 2 ** level
            for d in range(depths[level]):
                setattr(self, f"{prefix}_blk{d}", SwinBlock(
                    dim, num_heads[level], window, 0 if d % 2 == 0 else window // 2, (r, r),
                    mlp_ratio, dpr[sum(depths[:level]) + d]))

        for i in range(n):
            blocks(f"enc{i}", i)
            if i < n - 1:
                setattr(self, f"merge{i}", PatchMerging(embed_dim * 2 ** i))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (n - 1), eps=EPS)
        self.up0 = PatchExpand(embed_dim * 2 ** (n - 1))
        for i in range(1, n):
            li = n - 1 - i
            dim = embed_dim * 2 ** li
            setattr(self, f"concat_back_dim{i}", nn.Linear(2 * dim, dim))
            blocks(f"dec{i}", li)
            if i < n - 1:
                setattr(self, f"up{i}", PatchExpand(dim))
        self.norm_up = nn.LayerNorm(embed_dim, eps=EPS)
        self.final_expand = PatchExpand(embed_dim, scale=4, shrink=1)  # FinalPatchExpandX4
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's distributions beyond the zoo's conv rule: every
        linear truncated_normal(0.02) with a zero bias, and so every bias
        table; the LayerNorms keep their ones and zeros."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                truncated_normal_(m.weight, generator, 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                truncated_normal_(m.relative_position_bias_table, generator, 0.02)

    def _blocks(self, x, prefix, level, generator):
        for d in range(self.depths[level]):
            x = getattr(self, f"{prefix}_blk{d}")(x, generator)
        return x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        n = len(self.depths)
        skips = []
        for i in range(n):
            skips.append(x)
            x = self._blocks(x, f"enc{i}", i, generator)
            if i < n - 1:
                x = getattr(self, f"merge{i}")(x)
        x = self.up0(self.norm(x))
        for i in range(1, n):
            li = n - 1 - i
            x = getattr(self, f"concat_back_dim{i}")(torch.cat([x, skips[li]], -1))
            x = self._blocks(x, f"dec{i}", li, generator)
            if i < n - 1:
                x = getattr(self, f"up{i}")(x)
        x = self.final_expand(self.norm_up(x))
        return self.output(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

