"""KM_UNetV3 in its SH and LAPS variants (port of
``kmunet_tpu/models/km_unet.py``).

Input (B, H, W, in_frames) NHWC (5 frames by default), output (B, H, W,
num_classes) sigmoid maps; NCHW inside. Ladder at 128^2: 128 -> 64 -> 32 -> 16 (IWP x3), then 16 -> 32 -> 64
-> 128. SH: the DAGEM bridge, and DySample x2 upsamplings; LAPS: no bridge,
and align-corners bilinear x2 resizes. Kept quirks of the reference: the
EfficientViM blocks hardcode state_dim=64; the skip fusion takes [e1, e2,
e2]; the head is GroupNorm(1) (``head_norm``, on by default) then sigmoid.

``model.train()`` switches every BatchNorm to flax's training semantics and
the EnhancedViM blocks' stochastic depth on; the forward then takes the
``torch.Generator`` that DropPath draws from.

With a spatial axis in ``row_axis`` (``train.engine.shard_rows``: the
trainer's ``mesh.spatial`` > 1) the model takes and returns this rank's
block of image rows, as ``parallel/halo.py`` sets out: the convs taller than a row
read their neighbours' rows, the norms and means span the global image,
and the gathers and resizes read whole sources.
"""

from __future__ import annotations

import functools
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
from kmunet_tpu_torch.nn.fused_vim import FusedDirectionViM, StackedBranches
from kmunet_tpu_torch.nn.init import init_module_, kaiming_normal_fanout_
from kmunet_tpu_torch.nn.kan import KANConv2d
from kmunet_tpu_torch.nn.layers import DropPath, same_padding
from kmunet_tpu_torch.nn.resample import DySample
from kmunet_tpu_torch.nn.ssd import EfficientViMBlock
from kmunet_tpu_torch.nn.wavelet import IntelligentWaveletPooling
from kmunet_tpu_torch.ops.sample import resize_bilinear
from kmunet_tpu_torch.parallel.halo import (conv2d, group_norm, row_axis, sharded_rows,
                                            spatial_mean)


class StableHybridKANConv(nn.Module):
    """GroupNorm(4) pre-norm -> KANConv2d -> residual (1x1 conv when the
    width changes) -> ReLU; ``fused`` as in ``KANConv2d``."""

    def __init__(self, in_channels: int, features: int, fused: bool = False):
        super().__init__()
        self.pre_norm = nn.GroupNorm(4, in_channels, eps=1e-5)
        self.residual = nn.Conv2d(in_channels, features, 1) if in_channels != features else None
        self.kanconv = KANConv2d(in_channels, features, kernel_size=3, padding=1, fused=fused)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        if self.residual is not None:
            kaiming_normal_fanout_(self.residual.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = group_norm(self.pre_norm, x)
        identity = self.residual(x) if self.residual is not None else x
        return F.relu(identity + self.kanconv(x))


class DirectionViM(nn.Module):
    """Direction projection -> EfficientViM block (state_dim 64, a kept
    quirk) -> direction attention; ``ssd_mixer`` as ``HSMSSD``'s ``mixer``."""

    KERNELS = {"height": (3, 1), "width": (1, 3), "channel": (1, 1)}

    def __init__(self, channels: int, mode: str = "height", ssd_mixer: str = "einsum"):
        super().__init__()
        ks = self.KERNELS[mode]
        self.proj = nn.Conv2d(channels, channels, ks, padding=same_padding(ks))
        self.vit_mamba = EfficientViMBlock(channels, mlp_ratio=4, ssd_expand=1, state_dim=64,
                                           mixer=ssd_mixer)
        self.attn = DirectionAttention(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn(self.vit_mamba(conv2d(self.proj, x)))


class EnhancedViMBlock(nn.Module):
    """Three directional ViM branches blended by a softmax gate, then a
    TripleNorm + 1x1 MLP residual; both residual branches go through
    stochastic depth of rate ``drop_path``. ``impl`` lays the branches out
    as the JAX block's does, the same function in each: "separate" (three
    ``DirectionViM``s), "fused" (one ``FusedDirectionViM`` named
    ``directions``, its convs packed as ``packing`` says) or "vmap" (the
    projections ``height_proj``, ``width_proj``, ``channel_proj``, then one
    EfficientViM block and one DirectionAttention per branch held as stacked
    leaves, ``vit_mamba3`` and ``attn3``). ``ssd_mixer`` is the separate and
    vmap layouts' HSM-SSD path (the fused layout computes its mixers
    itself)."""

    IMPLS = ("separate", "fused", "vmap")

    def __init__(self, channels: int, expansion: int = 4, drop_path: float = 0.1,
                 ssd_mixer: str = "einsum", impl: str = "separate", packing: str = "grouped"):
        super().__init__()
        if impl not in self.IMPLS:
            raise ValueError(f"impl must be one of {self.IMPLS}, got {impl!r}")
        C = channels
        self.impl = impl
        if impl == "fused":
            self.directions = FusedDirectionViM(C, packing)
        elif impl == "vmap":
            for mode, ks in DirectionViM.KERNELS.items():
                setattr(self, f"{mode}_proj", nn.Conv2d(C, C, ks, padding=same_padding(ks)))
            self.vit_mamba3 = StackedBranches(functools.partial(
                EfficientViMBlock, C, mlp_ratio=4, ssd_expand=1, state_dim=64, mixer=ssd_mixer))
            self.attn3 = StackedBranches(functools.partial(DirectionAttention, C))
        else:
            self.height_block = DirectionViM(C, "height", ssd_mixer)
            self.width_block = DirectionViM(C, "width", ssd_mixer)
            self.channel_block = DirectionViM(C, "channel", ssd_mixer)
        self.Dense_0 = nn.Linear(3 * C, C // 4)
        self.Dense_1 = nn.Linear(C // 4, 3)
        self.drop_path = DropPath(drop_path)
        self.norm = TripleNorm(C)
        self.Conv_0 = nn.Conv2d(C, C * expansion, 1)
        self.Conv_1 = nn.Conv2d(C * expansion, C, 1)

    def _branches(self, x: torch.Tensor):
        if self.impl == "fused":
            return self.directions(x).unbind(1)
        if self.impl == "vmap":
            stacked = torch.stack([conv2d(getattr(self, f"{m}_proj"), x)
                                   for m in DirectionViM.KERNELS])
            return self.attn3(self.vit_mamba3(stacked)).unbind(0)
        return self.height_block(x), self.width_block(x), self.channel_block(x)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w, c = self._branches(x)
        gate_in = spatial_mean(torch.cat([h, w, c], dim=1))
        g = torch.softmax(self.Dense_1(F.gelu(self.Dense_0(gate_in))), dim=-1)
        g = g[:, :, None, None, None]  # (B, 3, 1, 1, 1)
        x = x + self.drop_path(g[:, 0] * h + g[:, 1] * w + g[:, 2] * c, generator)
        y = self.Conv_1(F.gelu(self.Conv_0(self.norm(x))))
        return x + self.drop_path(y, generator)


class KM_UNetV3(nn.Module):
    """The flagship. ``variant`` "sh": the DAGEM bridge and DySample
    upsampling; "laps": neither, align-corners bilinear x2 resizes instead
    (the JAX package's ``variant``). ``head_norm``: GroupNorm(1) on the head
    before the sigmoid. ``drop_path`` is the EnhancedViM blocks'
    stochastic-depth rate; ``dysample_window`` picks the three DySamples'
    path (the JAX package's ``DYSAMPLE_WINDOW``): True the dense window
    formulation, False the exact grouped gather (K4 on the card); the LAPS
    variant, which has no DySample, refuses False. ``kan_fused`` runs the
    four KAN convs through K1 and ``ssd_mixer`` ("einsum", "compress" or
    "fused") the 15 HSM-SSD mixers through K2 or K3 on the card: the same
    function as the defaults, which the JAX model computes. ``in_frames``:
    the input frames (channels of the first conv), which flax infers from
    its input."""

    def __init__(self, num_classes: int = 20, embed_dims=(16, 32, 64), drop_path: float = 0.1,
                 dysample_window: bool = True, kan_fused: bool = False,
                 ssd_mixer: str = "einsum", variant: str = "sh", head_norm: bool = True,
                 in_frames: int = 5):
        super().__init__()
        if variant not in ("sh", "laps"):
            raise ValueError(f"variant must be 'sh' or 'laps', got {variant!r}")
        if variant == "laps" and not dysample_window:
            raise ValueError("dysample_window=False: the LAPS variant has no DySample")
        self.variant = variant
        d0, d1, d2 = embed_dims
        self.conv_f = nn.Conv2d(in_frames, 16, 3, padding=1)
        widths = [16, d0, d1, d2]
        for i in (1, 2, 3):
            c_in, c = widths[i - 1], widths[i]
            setattr(self, f"enc{i}_kan", StableHybridKANConv(c_in, c, kan_fused))
            setattr(self, f"enc{i}_vim", EnhancedViMBlock(c, drop_path=drop_path,
                                                          ssd_mixer=ssd_mixer))
            setattr(self, f"enc{i}_iwp", IntelligentWaveletPooling(c))
            setattr(self, f"lca{i}", LocalContrastAttention(c))
        if variant == "sh":
            self.bridge = DAGEM(d2)
            self.dec1_up = DySample(d2, window=dysample_window)
        self.dec1_kan = StableHybridKANConv(d2, d1, kan_fused)
        self.attention1 = MultiScaleFusion((d0, d1, d1))
        if variant == "sh":
            self.dec2_up = DySample(2 * d1, window=dysample_window)
        self.dec2_conv = nn.Conv2d(2 * d1, d1, 3, padding=1)
        self.dec2_vim = EnhancedViMBlock(d1, drop_path=drop_path, ssd_mixer=ssd_mixer)
        self.attention2 = MultiScaleFusion((d0, d1, d1))
        if variant == "sh":
            self.dec3_up = DySample(2 * d1, window=dysample_window)
        self.dec3_conv = nn.Conv2d(2 * d1, d0, 3, padding=1)
        self.dec3_vim = EnhancedViMBlock(d0, drop_path=drop_path, ssd_mixer=ssd_mixer)
        self.head = nn.Conv2d(d0, num_classes, 3, padding=1)
        self.output_norm = nn.GroupNorm(1, num_classes, eps=1e-5) if head_norm else None
        self.row_axis = None

    def _global_size(self, x):
        """x's global (H, W): its rows times the spatial ranks."""
        axis = row_axis()
        H, W = x.shape[2:]
        return (H if axis is None else H * axis.size), W

    def _up2(self, x, name):
        if self.variant == "sh":
            return getattr(self, name)(x)
        H, W = self._global_size(x)
        return resize_bilinear(x, (2 * H, 2 * W), align_corners=True)

    def _skip(self, d, e1, e2, fusion):
        size = self._global_size(d)
        feats = [resize_bilinear(e, size, align_corners=True) for e in (e1, e2, e2)]
        return torch.cat([d, fusion(feats)], dim=1)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """frames (B, H, W, in_frames) -> (B, H, W, num_classes). ``generator`` (on
        the frames' device) feeds stochastic depth in training. With a row
        axis, H is this rank's block of rows."""
        with sharded_rows(self.row_axis):
            return self._forward(frames, generator)

    def _forward(self, frames, generator):
        x = conv2d(self.conv_f, frames.permute(0, 3, 1, 2))
        skips = []
        for i in (1, 2, 3):
            x = getattr(self, f"enc{i}_kan")(x)
            x = getattr(self, f"enc{i}_vim")(x, generator)
            x = getattr(self, f"enc{i}_iwp")(x)
            x = getattr(self, f"lca{i}")(x)
            skips.append(x)
        e1, e2, e3 = skips
        bridge = self.bridge(e3) if self.variant == "sh" else e3
        d = self.dec1_kan(self._up2(bridge, "dec1_up"))
        d = self._skip(d, e1, e2, self.attention1)
        d = self.dec2_vim(conv2d(self.dec2_conv, self._up2(d, "dec2_up")), generator)
        d = self._skip(d, e1, e2, self.attention2)
        d = self.dec3_vim(conv2d(self.dec3_conv, self._up2(d, "dec3_up")), generator)
        d = conv2d(self.head, d)
        if self.output_norm is not None:
            d = group_norm(self.output_norm, d)
        return torch.sigmoid(d).permute(0, 2, 3, 1)


def KM_UNetV3_SH(num_classes: int = 20, embed_dims=(16, 32, 64), drop_path: float = 0.1,
                 dysample_window: bool = True, kan_fused: bool = False,
                 ssd_mixer: str = "einsum", head_norm: bool = True) -> KM_UNetV3:
    """Shanghai variant (20 forecast frames from 5 input frames)."""
    return KM_UNetV3(num_classes=num_classes, embed_dims=tuple(embed_dims), drop_path=drop_path,
                     dysample_window=dysample_window, kan_fused=kan_fused, ssd_mixer=ssd_mixer,
                     head_norm=head_norm)


def KM_UNetV3_LAPS(num_classes: int = 3, embed_dims=(16, 32, 64), drop_path: float = 0.1,
                   kan_fused: bool = False, ssd_mixer: str = "einsum",
                   head_norm: bool = True) -> KM_UNetV3:
    """LAPS/NC variant (3 forecast frames from 5 input frames)."""
    return KM_UNetV3(num_classes=num_classes, embed_dims=tuple(embed_dims), drop_path=drop_path,
                     kan_fused=kan_fused, ssd_mixer=ssd_mixer, variant="laps",
                     head_norm=head_norm)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions
    (``nn.init.init_module_``): convs and linears PyTorch's default
    kaiming-uniform weight and a zero bias, then every module's own rule."""
    return init_module_(model, generator)
