"""KM_UNetV3, SH variant (port of ``kmunet_tpu/models/km_unet.py``).

Input (B, H, W, frames) NHWC, output (B, H, W, num_classes) sigmoid maps;
NCHW inside. Ladder at 128^2: 128 -> 64 -> 32 -> 16 (IWP x3), the DAGEM
bridge, then 16 -> 32 -> 64 -> 128 (DySample x3). Kept quirks of the
reference: the EfficientViM blocks hardcode state_dim=64; the skip fusion
takes [e1, e2, e2]; the head is GroupNorm(1) then sigmoid.

``model.train()`` switches every BatchNorm to flax's training semantics and
the EnhancedViM blocks' stochastic depth on; the forward then takes the
``torch.Generator`` that DropPath draws from.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.attention import (
    DirectionAttention,
    LocalContrastAttention,
    MultiScaleFusion,
    TripleNorm,
)
from kmunet_tpu_torch.nn.dagem import DAGEM
from kmunet_tpu_torch.nn.init import kaiming_normal_fanout_, kaiming_uniform_
from kmunet_tpu_torch.nn.kan import KANConv2d
from kmunet_tpu_torch.nn.layers import DropPath, same_padding
from kmunet_tpu_torch.nn.resample import DySample
from kmunet_tpu_torch.nn.ssd import EfficientViMBlock
from kmunet_tpu_torch.nn.wavelet import IntelligentWaveletPooling
from kmunet_tpu_torch.ops.sample import resize_bilinear


class StableHybridKANConv(nn.Module):
    """GroupNorm(4) pre-norm -> KANConv2d -> residual (1x1 conv when the
    width changes) -> ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.pre_norm = nn.GroupNorm(4, in_channels, eps=1e-5)
        self.residual = nn.Conv2d(in_channels, features, 1) if in_channels != features else None
        self.kanconv = KANConv2d(in_channels, features, kernel_size=3, padding=1)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        if self.residual is not None:
            kaiming_normal_fanout_(self.residual.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre_norm(x)
        identity = self.residual(x) if self.residual is not None else x
        return F.relu(identity + self.kanconv(x))


class DirectionViM(nn.Module):
    """Direction projection -> EfficientViM block (state_dim 64, a kept
    quirk) -> direction attention."""

    KERNELS = {"height": (3, 1), "width": (1, 3), "channel": (1, 1)}

    def __init__(self, channels: int, mode: str = "height"):
        super().__init__()
        ks = self.KERNELS[mode]
        self.proj = nn.Conv2d(channels, channels, ks, padding=same_padding(ks))
        self.vit_mamba = EfficientViMBlock(channels, mlp_ratio=4, ssd_expand=1, state_dim=64)
        self.attn = DirectionAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn(self.vit_mamba(self.proj(x)))


class EnhancedViMBlock(nn.Module):
    """Three directional ViM branches blended by a softmax gate, then a
    TripleNorm + 1x1 MLP residual (the 'separate' layout); both residual
    branches go through stochastic depth of rate ``drop_path``."""

    def __init__(self, channels: int, expansion: int = 4, drop_path: float = 0.1):
        super().__init__()
        C = channels
        self.height_block = DirectionViM(C, "height")
        self.width_block = DirectionViM(C, "width")
        self.channel_block = DirectionViM(C, "channel")
        self.Dense_0 = nn.Linear(3 * C, C // 4)
        self.Dense_1 = nn.Linear(C // 4, 3)
        self.drop_path = DropPath(drop_path)
        self.norm = TripleNorm(C)
        self.Conv_0 = nn.Conv2d(C, C * expansion, 1)
        self.Conv_1 = nn.Conv2d(C * expansion, C, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.height_block(x)
        w = self.width_block(x)
        c = self.channel_block(x)
        gate_in = torch.cat([h, w, c], dim=1).mean(dim=(2, 3))
        g = torch.softmax(self.Dense_1(F.gelu(self.Dense_0(gate_in))), dim=-1)
        g = g[:, :, None, None, None]  # (B, 3, 1, 1, 1)
        x = x + self.drop_path(g[:, 0] * h + g[:, 1] * w + g[:, 2] * c, generator)
        y = self.Conv_1(F.gelu(self.Conv_0(self.norm(x))))
        return x + self.drop_path(y, generator)


class KM_UNetV3(nn.Module):
    """The flagship, SH variant: DAGEM bridge and DySample upsampling.
    ``drop_path`` is the EnhancedViM blocks' stochastic-depth rate."""

    def __init__(self, num_classes: int = 20, embed_dims=(16, 32, 64), drop_path: float = 0.1):
        super().__init__()
        d0, d1, d2 = embed_dims
        self.conv_f = nn.Conv2d(5, 16, 3, padding=1)  # 5 input frames
        widths = [16, d0, d1, d2]
        for i in (1, 2, 3):
            c_in, c = widths[i - 1], widths[i]
            setattr(self, f"enc{i}_kan", StableHybridKANConv(c_in, c))
            setattr(self, f"enc{i}_vim", EnhancedViMBlock(c, drop_path=drop_path))
            setattr(self, f"enc{i}_iwp", IntelligentWaveletPooling(c))
            setattr(self, f"lca{i}", LocalContrastAttention(c))
        self.bridge = DAGEM(d2)
        self.dec1_up = DySample(d2)
        self.dec1_kan = StableHybridKANConv(d2, d1)
        self.attention1 = MultiScaleFusion((d0, d1, d1))
        self.dec2_up = DySample(2 * d1)
        self.dec2_conv = nn.Conv2d(2 * d1, d1, 3, padding=1)
        self.dec2_vim = EnhancedViMBlock(d1, drop_path=drop_path)
        self.attention2 = MultiScaleFusion((d0, d1, d1))
        self.dec3_up = DySample(2 * d1)
        self.dec3_conv = nn.Conv2d(2 * d1, d0, 3, padding=1)
        self.dec3_vim = EnhancedViMBlock(d0, drop_path=drop_path)
        self.head = nn.Conv2d(d0, num_classes, 3, padding=1)
        self.output_norm = nn.GroupNorm(1, num_classes, eps=1e-5)

    def _skip(self, d, e1, e2, fusion):
        size = d.shape[2:]
        feats = [resize_bilinear(e, size, align_corners=True) for e in (e1, e2, e2)]
        return torch.cat([d, fusion(feats)], dim=1)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames (B, H, W, 5) -> (B, H, W, num_classes). ``generator`` (on
        the frames' device) feeds stochastic depth in training."""
        x = self.conv_f(frames.permute(0, 3, 1, 2))
        skips = []
        for i in (1, 2, 3):
            x = getattr(self, f"enc{i}_kan")(x)
            x = getattr(self, f"enc{i}_vim")(x, generator)
            x = getattr(self, f"enc{i}_iwp")(x)
            x = getattr(self, f"lca{i}")(x)
            skips.append(x)
        e1, e2, e3 = skips
        d = self.dec1_kan(self.dec1_up(self.bridge(e3)))
        d = self._skip(d, e1, e2, self.attention1)
        d = self.dec2_vim(self.dec2_conv(self.dec2_up(d)), generator)
        d = self._skip(d, e1, e2, self.attention2)
        d = self.dec3_vim(self.dec3_conv(self.dec3_up(d)), generator)
        return torch.sigmoid(self.output_norm(self.head(d))).permute(0, 2, 3, 1)


def KM_UNetV3_SH(num_classes: int = 20, embed_dims=(16, 32, 64),
                 drop_path: float = 0.1) -> KM_UNetV3:
    """Shanghai variant (20 forecast frames from 5 input frames)."""
    return KM_UNetV3(num_classes=num_classes, embed_dims=tuple(embed_dims), drop_path=drop_path)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions.

    Convs and linears get PyTorch's default kaiming-uniform weight and a zero
    bias; then every module with its own rule (``init_weights_``) applies it.
    Norms, BN statistics and the constant parameters keep the values their
    constructors give.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            kaiming_uniform_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_weights_"):
            m.init_weights_(generator)
    return model
