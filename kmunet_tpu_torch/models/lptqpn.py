"""LPTQPN baseline (port of ``kmunet_tpu/models/lptqpn.py``): a
Restormer-style U-Net of channel-transposed attention.

Multi-head "squared" attention over the C x C gram of each head with
sigmoid (not softmax) scores and a learned per-head ``temperature``
(heads, 1, 1), a gated depthwise-conv FFN of hidden width ``int(C *
expansion)``, a bias-free channel LayerNorm (eps 1e-5) wrapped in a
sigmoid, pixel-unshuffle downs and pixel-shuffle ups, the last input frame
added before the head and a learnable-beta Swish (``swish_beta``, 0-d).
Takes (B, H, W, frames) and returns (B, H, W, out_frames); NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.resample import pixel_shuffle, pixel_unshuffle


def _conv(cin: int, f: int, k: int, bias: bool, groups: int = 1) -> nn.Conv2d:
    """flax ``Conv(f, (k, k), padding='SAME')`` at stride 1 (odd k)."""
    return nn.Conv2d(cin, f, k, padding=k // 2, bias=bias, groups=groups)


class SigmoidLayerNorm(nn.Module):
    """sigmoid of a bias-free LayerNorm over the channels (biased variance,
    eps 1e-5)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(1, keepdim=True)
        var = (x - mu).square().mean(1, keepdim=True)
        return torch.sigmoid((x - mu) * torch.rsqrt(var + 1e-5) * self.weight[:, None, None])


class SquaredAttention(nn.Module):
    """qkv by a 1x1 and a depthwise 3x3 conv; per head, q and k
    L2-normalised over the pixels, sigmoid(q k^T * temperature) (ch x ch)
    applied to v; a 1x1 projection."""

    def __init__(self, channels: int, num_heads: int, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _conv(channels, 3 * channels, 1, bias)
        self.qkv_dwconv = _conv(3 * channels, 3 * channels, 3, bias, groups=3 * channels)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.project_out = _conv(channels, channels, 1, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).reshape(B, 3, self.num_heads, C // self.num_heads,
                                                       H * W).unbind(1)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.sigmoid(q @ k.transpose(-1, -2) * self.temperature)
        return self.project_out((attn @ v).reshape(B, C, H, W))


class GDFN(nn.Module):
    """Gated depthwise-conv feed-forward: 1x1 to 2 x hidden, depthwise 3x3,
    gelu(first half) * sigmoid(second half), 1x1 back."""

    def __init__(self, channels: int, expansion: float = 2.66, bias: bool = False):
        super().__init__()
        hidden = int(channels * expansion)
        self.project_in = _conv(channels, 2 * hidden, 1, bias)
        self.dwconv = _conv(2 * hidden, 2 * hidden, 3, bias, groups=2 * hidden)
        self.project_out = _conv(hidden, channels, 1, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1, y2 = self.dwconv(self.project_in(x)).chunk(2, 1)
        return self.project_out(F.gelu(y1) * torch.sigmoid(y2))


class TransformerBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, expansion: float = 2.66,
                 bias: bool = False):
        super().__init__()
        self.norm1 = SigmoidLayerNorm(channels)
        self.attn = SquaredAttention(channels, num_heads, bias)
        self.norm2 = SigmoidLayerNorm(channels)
        self.ffn = GDFN(channels, expansion, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class LPTQPN(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, out_frames); H and W multiples of
    8. Blocks are named ``{stage}_{i}`` as in flax (``enc1_0``, ...)."""

    def __init__(self, out_frames: int = 20, dim: int = 20,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 2,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66, bias: bool = False,
                 in_channels: int = 5):
        super().__init__()
        d = dim
        self.stages = []

        def blocks(name, channels, n, h):
            for i in range(n):
                setattr(self, f"{name}_{i}", TransformerBlock(channels, h, expansion, bias))
            self.stages.append((name, n))

        self.patch_embed = _conv(in_channels, d, 3, False)
        blocks("enc1", d, num_blocks[0], heads[0])
        self.down1 = _conv(d, d // 2, 3, False)
        blocks("enc2", 2 * d, num_blocks[1], heads[1])
        self.down2 = _conv(2 * d, d, 3, False)
        blocks("enc3", 4 * d, num_blocks[2], heads[2])
        self.down3 = _conv(4 * d, 2 * d, 3, False)
        blocks("central", 8 * d, num_blocks[3], heads[3])
        self.up3 = _conv(8 * d, 16 * d, 3, False)
        self.reduce3 = _conv(8 * d, 4 * d, 1, bias)
        blocks("dec3", 4 * d, num_blocks[2], heads[2])
        self.up2 = _conv(4 * d, 8 * d, 3, False)
        self.reduce2 = _conv(4 * d, 2 * d, 1, bias)
        blocks("dec2", 2 * d, num_blocks[1], heads[1])
        self.up1 = _conv(2 * d, 4 * d, 3, False)
        blocks("dec1", 2 * d, num_blocks[0], heads[0])
        blocks("refine", 2 * d, num_refinement_blocks, heads[0])
        self.output = _conv(2 * d, out_frames, 3, bias)
        self.last_conv = _conv(out_frames, out_frames, 3, True)
        self.swish_beta = nn.Parameter(torch.ones(()))
        self.stages = dict(self.stages)

    def _blocks(self, y: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(self.stages[name]):
            y = getattr(self, f"{name}_{i}")(y)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        e1 = self._blocks(self.patch_embed(x), "enc1")
        e2 = self._blocks(pixel_unshuffle(self.down1(e1), 2), "enc2")
        e3 = self._blocks(pixel_unshuffle(self.down2(e2), 2), "enc3")
        c = self._blocks(pixel_unshuffle(self.down3(e3), 2), "central")
        y = self.reduce3(torch.cat([pixel_shuffle(self.up3(c), 2), e3], 1))
        y = self._blocks(y, "dec3")
        y = self.reduce2(torch.cat([pixel_shuffle(self.up2(y), 2), e2], 1))
        y = self._blocks(y, "dec2")
        y = torch.cat([pixel_shuffle(self.up1(y), 2), e1], 1)  # 2d channels, no reduce
        y = self._blocks(self._blocks(y, "dec1"), "refine")
        y = self.output(y) + x[:, -1:]  # the last input frame, to every output frame
        y = self.last_conv(y)
        return (y * torch.sigmoid(self.swish_beta * y)).permute(0, 2, 3, 1)
