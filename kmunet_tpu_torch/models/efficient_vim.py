"""The EfficientViM image classifier (port of
``kmunet_tpu/models/efficient_vim.py``).

A 16x conv stem, three stages of EfficientViM blocks with SE patch merges
between them, and the hidden-state fusion head: per stage the last block's
HSM-SSD hidden state h (B, N, C) is normalised over C, averaged over its N
states and mapped to logits by the stage's head; a fourth head reads the
normalised, pooled final feature map; the four are summed with softmax
weights. ``distillation`` adds a second ladder of four heads and weights: in
training the forward returns ``(z, z_dist)``, in eval their mean, and
keeps the pair on ``logits_pair`` (what the JAX model sows as
``intermediates/logits_pair``). M1-M4 are the published widths, depths and
state sizes.

Images come in as (B, H, W, 3) NHWC, as the JAX model takes them; NCHW
inside. ``ssd_mixer`` ("einsum", "compress" or "fused") runs the blocks'
HSM-SSD mixers through K2 or K3 on the card, as in ``KM_UNetV3``: the same
function. At 224^2 the mixers see L = 196, 49 and 16 tokens.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from kmunet_tpu_torch.nn.init import truncated_normal_
from kmunet_tpu_torch.nn.layers import ChannelLayerNorm, PatchMerging, Stem
from kmunet_tpu_torch.nn.ssd import EfficientViMBlock


class _BlockWithState(EfficientViMBlock):
    """``EfficientViMBlock`` that also returns its mixer's hidden state h_
    (B, N, C), which the fusion head reads."""

    def forward(self, x: torch.Tensor):
        a = torch.sigmoid(self.alpha)[:, None, :, None, None]  # (4, 1, C, 1, 1)
        x = (1 - a[0]) * x + a[0] * self.dwconv1(x)
        y, h = self.mixer(self.norm(x))
        x = (1 - a[1]) * x + a[1] * y
        x = (1 - a[2]) * x + a[2] * self.dwconv2(x)
        return (1 - a[3]) * x + a[3] * self.ffn(x), h


class EfficientViM(nn.Module):
    """(B, H, W, 3) images -> (B, num_classes) logits (the module
    docstring); H and W multiples of 64 keep every stage's token grid
    square."""

    def __init__(self, num_classes: int = 1000, embed_dim: Sequence[int] = (128, 256, 512),
                 depths: Sequence[int] = (2, 2, 2), mlp_ratio: float = 4.0,
                 ssd_expand: int = 1, state_dim: Sequence[int] = (49, 25, 9),
                 distillation: bool = False, ssd_mixer: str = "einsum"):
        super().__init__()
        self.depths = tuple(depths)
        self.distillation = distillation
        self.logits_pair = None
        self.patch_embed = Stem(3, embed_dim[0])
        self.weights = nn.Parameter(torch.ones(4))
        if distillation:
            self.weights_dist = nn.Parameter(torch.ones(4))
        for i, depth in enumerate(self.depths):
            C = embed_dim[i]
            for d in range(depth):
                setattr(self, f"stage{i}_blk{d}",
                        _BlockWithState(C, mlp_ratio, ssd_expand, state_dim[i], mixer=ssd_mixer))
            setattr(self, f"norm{i}", ChannelLayerNorm(C))
            if i < len(self.depths) - 1:
                setattr(self, f"merge{i}", PatchMerging(C, embed_dim[i + 1]))
        self.norm3 = ChannelLayerNorm(embed_dim[len(self.depths) - 1])
        for i in range(4):
            C = embed_dim[min(i, len(self.depths) - 1)]
            setattr(self, f"head{i}", nn.Linear(C, num_classes))
            if distillation:
                setattr(self, f"head{i}_dist", nn.Linear(C, num_classes))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        """The heads' flax init: truncated_normal(0.02) kernels, zero biases."""
        for name, m in self.named_children():
            if name.startswith("head"):
                truncated_normal_(m.weight, generator, 0.02)
                m.bias.zero_()

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        w = torch.softmax(self.weights, dim=0)
        z = 0.0
        if self.distillation:
            w_dist = torch.softmax(self.weights_dist, dim=0)
            z_dist = 0.0
        for i, depth in enumerate(self.depths):
            h = None
            for d in range(depth):
                x, h = getattr(self, f"stage{i}_blk{d}")(x)
            # h (B, N, C): normalised over C, averaged over the N states.
            hp = getattr(self, f"norm{i}")(h.transpose(1, 2)).mean(dim=2)
            z = z + w[i] * getattr(self, f"head{i}")(hp)
            if self.distillation:
                z_dist = z_dist + w_dist[i] * getattr(self, f"head{i}_dist")(hp)
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge{i}")(x)
        xp = self.norm3(x).mean(dim=(2, 3))
        z = z + w[3] * self.head3(xp)
        if not self.distillation:
            return z
        z_dist = z_dist + w_dist[3] * self.head3_dist(xp)
        if self.training:
            return z, z_dist
        self.logits_pair = (z, z_dist)
        return (z + z_dist) / 2


def EfficientViM_M1(**kw) -> EfficientViM:
    return EfficientViM(embed_dim=(128, 192, 320), depths=(2, 2, 2), state_dim=(49, 25, 9), **kw)


def EfficientViM_M2(**kw) -> EfficientViM:
    return EfficientViM(embed_dim=(128, 256, 512), depths=(2, 2, 2), state_dim=(49, 25, 9), **kw)


def EfficientViM_M3(**kw) -> EfficientViM:
    return EfficientViM(embed_dim=(224, 320, 512), depths=(2, 2, 2), state_dim=(49, 25, 9), **kw)


def EfficientViM_M4(**kw) -> EfficientViM:
    return EfficientViM(embed_dim=(224, 320, 512), depths=(3, 4, 2), state_dim=(64, 32, 16), **kw)


VARIANTS = {"m1": EfficientViM_M1, "m2": EfficientViM_M2, "m3": EfficientViM_M3,
            "m4": EfficientViM_M4}
