"""TransUNet baseline (port of ``kmunet_tpu/models/transunet.py``): an
R50 + ViT-B/16 hybrid encoder with a cascaded upsampling decoder.

A pre-activation ResNetV2 stem (blocks 3 / 4 / 9, width 64) of
weight-standardised convs, a 1x1 patch embedding with zero-initialised
position embeddings, 12 pre-LN transformer layers (12 heads, MLP 3072,
dropout 0.1 in training), a 3x3 conv to 512, four align-corners bilinear
x2 up-blocks with skip concatenation (512, 256 and 64 channels), a 3x3
head. Takes (B, H, W, frames) and returns (B, H, W, num_classes); NCHW
inside. flax's GroupNorm (``gn_proj``) takes eps 1e-6, and so do the
others and the LayerNorms by their arguments; the BatchNorms take 1e-5.

Kept quirks of the reference: the root max-pool is 3x3, stride 2, padding
0 (63^2 at a 256^2 input); the skip it stores is zero-padded back to 64^2
on the bottom and right while the main path stays 63^2. Strided "SAME"
convs pad as XLA does (the odd pixel after: ``nn.layers.pad_same``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.init import kaiming_uniform_, normal_, xavier_uniform_
from kmunet_tpu_torch.nn.layers import Dropout, batch_norm, pad_same
from kmunet_tpu_torch.ops.sample import resize_bilinear

EPS = 1e-6


class WSConv(nn.Module):
    """A bias-free conv whose kernel is standardised over (in, kh, kw) on
    every call: (w - mean) / sqrt(biased var + 1e-5). ``padding`` "SAME"
    (XLA's, at ``stride``) or an int."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding="SAME"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.stride, self.padding = stride, padding

    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        m = w.mean((1, 2, 3), keepdim=True)
        v = (w - m).square().mean((1, 2, 3), keepdim=True)
        w = (w - m) * torch.rsqrt(v + 1e-5)
        if self.padding == "SAME":
            x = pad_same(x, w.shape[2:], (self.stride, self.stride))
            return F.conv2d(x, w, stride=self.stride)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class PreActBottleneck(nn.Module):
    """conv1 1x1, GN, ReLU; conv2 3x3 at ``stride``, GN, ReLU; conv3 1x1, GN;
    plus the residual (a 1x1 ``downsample`` and ``gn_proj`` where the
    stride or width changes); ReLU."""

    def __init__(self, in_channels: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        if stride != 1 or in_channels != cout:
            self.downsample = WSConv(in_channels, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout, eps=EPS)
        else:
            self.downsample = None
        self.conv1 = WSConv(in_channels, cmid, 1)
        self.gn1 = nn.GroupNorm(32, cmid, eps=EPS)
        self.conv2 = WSConv(cmid, cmid, 3, stride)
        self.gn2 = nn.GroupNorm(32, cmid, eps=EPS)
        self.conv3 = WSConv(cmid, cout, 1)
        self.gn3 = nn.GroupNorm(32, cout, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


class ResNetV2(nn.Module):
    """Returns the last block's map and the skips, deepest first: block 2's
    and block 1's outputs (each zero-padded to in_size / 8 and in_size / 4)
    and the root's."""

    def __init__(self, in_channels: int, block_units: Sequence[int] = (3, 4, 9), width: int = 64):
        super().__init__()
        w = width
        self.root_conv = WSConv(in_channels, w, 7, 2, padding=3)
        self.root_gn = nn.GroupNorm(32, w, eps=EPS)
        self.units = []
        cin = w
        for bi, (cout, cmid, stride) in enumerate([(w * 4, w, 1), (w * 8, w * 2, 2),
                                                   (w * 16, w * 4, 2)]):
            names = []
            for ui in range(block_units[bi]):
                name = f"block{bi + 1}_unit{ui + 1}"
                setattr(self, name, PreActBottleneck(cin, cout, cmid, stride if ui == 0 else 1))
                names.append(name)
                cin = cout
            self.units.append(names)
        self.out_channels = cin

    def forward(self, x: torch.Tensor):
        in_size = x.shape[2]
        x = F.relu(self.root_gn(self.root_conv(x)))
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        for bi, names in enumerate(self.units):
            for name in names:
                x = getattr(self, name)(x)
            if bi < len(self.units) - 1:
                pad = in_size // 4 // (bi + 1) - x.shape[2]
                features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return x, features[::-1]


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    ``query``, ``key``, ``value`` and ``out`` linears (flax's DenseGeneral
    kernels (in, heads, head_dim) and (heads, head_dim, out), flattened),
    softmax(q k^T / sqrt(head_dim)) v."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape

        def split(t):
            return t.reshape(B, L, self.heads, D // self.heads).transpose(1, 2)

        y = F.scaled_dot_product_attention(split(self.query(x)), split(self.key(x)),
                                           split(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(B, L, D))


class ViTBlock(nn.Module):
    def __init__(self, hidden: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 dropout: float = 0.1):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=EPS)
        self.attn = MultiHeadDotProductAttention(hidden, heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=EPS)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.drop = Dropout(dropout)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        for lin in (self.attn.query, self.attn.key, self.attn.value, self.attn.out):
            xavier_uniform_(lin.weight, generator)
        for lin in (self.fc1, self.fc2):
            xavier_uniform_(lin.weight, generator)
            normal_(lin.bias, generator, std=1e-6)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        h = self.drop(F.gelu(self.fc1(self.ffn_norm(x))), generator)
        return x + self.drop(self.fc2(h), generator)


class Conv2dReLU(nn.Module):
    """A bias-free 3x3 conv, BatchNorm (eps 1e-5), ReLU."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(batch_norm(self.Conv_0(x), self.BatchNorm_0))


class TransUNet(nn.Module):
    """R50-ViT-B/16: (B, H, W, in_channels) -> (B, H, W, num_classes), H = W
    a multiple of 16. ``img_size`` fixes the patch grid, and with it the
    position embeddings' shape, (1, (img_size / 16)^2, hidden). In training
    the forward takes the ``torch.Generator`` its dropouts draw from."""

    def __init__(self, num_classes: int = 20, hidden: int = 768, layers: int = 12,
                 heads: int = 12, mlp_dim: int = 3072,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16), n_skip: int = 3,
                 dropout: float = 0.1, in_channels: int = 5, img_size: int = 256):
        super().__init__()
        self.hidden, self.layers, self.n_skip = hidden, layers, n_skip
        self.in_channels = in_channels
        rgb = 3 if in_channels == 1 else in_channels  # one channel is tiled to three
        self.hybrid_model = ResNetV2(rgb)
        self.patch_embeddings = nn.Conv2d(self.hybrid_model.out_channels, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, (img_size // 16) ** 2, hidden))
        self.drop = Dropout(dropout)
        for i in range(layers):
            setattr(self, f"block{i}", ViTBlock(hidden, heads, mlp_dim, dropout))
        self.encoder_norm = nn.LayerNorm(hidden, eps=EPS)
        self.conv_more = Conv2dReLU(hidden, 512)
        skip_channels = [4 * 64 * 2, 4 * 64, 64]  # block 2's, block 1's and the root's
        cin = 512
        for i, out_c in enumerate(decoder_channels):
            skip = skip_channels[i] if i < min(n_skip, len(skip_channels)) else 0
            setattr(self, f"dec{i}_conv1", Conv2dReLU(cin + skip, out_c))
            setattr(self, f"dec{i}_conv2", Conv2dReLU(out_c, out_c))
            cin = out_c
        self.decoder_blocks = len(decoder_channels)
        self.segmentation_head = nn.Conv2d(cin, num_classes, 3, padding=1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        feat, skips = self.hybrid_model(x)
        y = self.patch_embeddings(feat)
        B, _, hh, ww = y.shape
        tokens = y.flatten(2).transpose(1, 2)
        tokens = self.drop(tokens + self.position_embeddings, generator)
        for i in range(self.layers):
            tokens = getattr(self, f"block{i}")(tokens, generator)
        tokens = self.encoder_norm(tokens)
        y = self.conv_more(tokens.transpose(1, 2).reshape(B, self.hidden, hh, ww))
        for i in range(self.decoder_blocks):
            H, W = y.shape[2:]
            y = resize_bilinear(y, (2 * H, 2 * W), align_corners=True)
            if i < self.n_skip and i < len(skips):
                y = torch.cat([y, skips[i]], 1)
            y = getattr(self, f"dec{i}_conv2")(getattr(self, f"dec{i}_conv1")(y))
        return self.segmentation_head(y).permute(0, 2, 3, 1)
