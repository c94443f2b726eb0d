"""Mamba-UNet baseline (port of ``kmunet_tpu/models/mamba_unet.py``): a UNet
whose deep stages and refinement layers are dual-view Mamba mixers (DMFM).

conv encoders 1-3 + DMFM encoders 4-6, a multi-scale spatio-temporal
attention bridge over 5 skips, DMFM and conv decoders with 2x2 transposed
convs, 4 refinement DMFMs at full resolution, the last input frame added
before the output conv, and a learnable-beta Swish. Takes (B, H, W, frames)
and returns (B, H, W, predicted_frames) as the JAX model does; NCHW inside.

Every DMFM runs its one ``MambaBlock`` on two token views, so a forward
launches the selective scan (K8 on a CUDA tensor) 20 times. Submodules
carry the flax names; flax's LayerNorm and GroupNorm take eps 1e-6.

With a spatial axis in ``row_axis`` (``train.engine.shard_rows``) the
forward runs on this rank's block of image rows (``parallel/halo.py``):
the 3x3, 3x1 and the bridge's dilated 7x7 convs read their halo rows, the
GroupNorms and the channel bridge's pools take the whole image's
statistics, the 2x2 pools and transposed convs are row-local (a rank's
rows stay even down to the last pool: H a multiple of 32 x spatial), and
every DMFM's tokens are the rank's rows, a chunk of the row-major sequence
(``MambaBlock`` on sharded rows).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.models.ef import conv_t
from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.nn.layers import same_padding
from kmunet_tpu_torch.nn.mamba import MambaBlock
from kmunet_tpu_torch.parallel.halo import (conv2d, conv_transpose2d, group_norm, sharded_rows,
                                            spatial_mean)

EPS = 1e-6  # flax's LayerNorm and GroupNorm default


def _conv(cin: int, f: int, k) -> nn.Conv2d:
    """flax ``Conv(f, k, padding='SAME')`` at stride 1 (odd kernels)."""
    k = (k, k) if isinstance(k, int) else tuple(k)
    return nn.Conv2d(cin, f, k, padding=same_padding(k))


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(4, channels, eps=EPS)


def _up(channels: int) -> nn.ConvTranspose2d:
    """flax ``ConvTranspose(f, (2, 2), strides=(2, 2), padding='SAME',
    transpose_kernel=True)``: each input pixel to its own 2x2 block, which is
    PyTorch's padding 0 with the kernel unflipped (``ef.conv_t``)."""
    return conv_t(channels, channels, 2, 2, 0)


class DMFMLayer(nn.Module):
    """Dual-view Mamba feature mixer on NCHW maps: one LayerNorm (used three
    times) and one MambaBlock (used on both views) over the H*W tokens in
    row-major order; the second view shuffles the channels in groups of
    ``group`` as the JAX layer does in NHWC (channel g * C/group + i to
    i * group + g). ``seq_mesh``: the MambaBlock's sequence-parallel scan."""

    def __init__(self, input_dim: int, output_dim: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, group: int = 8, seq_mesh=None):
        super().__init__()
        self.group = group
        self.norm = nn.LayerNorm(input_dim, eps=EPS)
        self.mamba = MambaBlock(input_dim, d_state, d_conv, expand, seq_mesh=seq_mesh)
        self.skip_scale1 = nn.Parameter(torch.ones(1))
        self.skip_scale2 = nn.Parameter(torch.ones(1))
        self.proj = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        x1 = self.norm(tokens)
        shuffled = tokens.reshape(B, H * W, self.group, C // self.group).transpose(2, 3)
        x2 = self.norm(shuffled.reshape(B, H * W, C))
        m1 = self.mamba(x1) + x1 * self.skip_scale1
        m2 = self.mamba(x2) + x2 * self.skip_scale2
        y = self.proj(self.norm(m1 + m2))
        return y.reshape(B, H, W, -1).permute(0, 3, 1, 2)


class SpatialAttBridge(nn.Module):
    """Shared dilated 7x7 spatial attention over each map's channel mean and
    max."""

    def __init__(self):
        super().__init__()
        self.shared_conv2d = nn.Conv2d(2, 1, 7, padding=9, dilation=3)

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.sigmoid(conv2d(self.shared_conv2d, torch.cat(
            [t.mean(1, keepdim=True), t.amax(1, keepdim=True)], 1))) for t in ts]


class ChannelAttBridge(nn.Module):
    """A bias-free conv1d (k3, padding 1) over the concatenated global
    average pools, then one linear per scale. ``get_all_att_weight``
    (1, 1, 3) is flax's ``get_all_att_kernel`` (3, 1, 1)."""

    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.get_all_att_weight = nn.Parameter(torch.empty(1, 1, 3))
        for i, c in enumerate(c_list):
            setattr(self, f"att{i + 1}", nn.Linear(sum(c_list), c))

    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.get_all_att_weight, generator)

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        gap = torch.cat([spatial_mean(t) for t in ts], -1)
        att = F.conv1d(gap[:, None], self.get_all_att_weight, padding=1)[:, 0]
        return [torch.sigmoid(getattr(self, f"att{i + 1}")(att))[:, :, None, None]
                for i in range(len(ts))]


class MultiScaleSTAMBridge(nn.Module):
    """Triple-kernel (3x3, 1x3, 3x1) spatial attention and channel
    attention over the skips, weighted by the 0-d ``alpha1..3``."""

    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.n = len(c_list)
        self.alpha1 = nn.Parameter(torch.ones(()))
        self.alpha2 = nn.Parameter(torch.ones(()))
        self.alpha3 = nn.Parameter(torch.ones(()))
        for i, c in enumerate(c_list):
            setattr(self, f"conv1_1_{i + 1}", _conv(c, c, 3))
            setattr(self, f"conv1_3_{i + 1}", _conv(c, c, (1, 3)))
            setattr(self, f"conv3_1_{i + 1}", _conv(c, c, (3, 1)))
        self.satt = SpatialAttBridge()
        self.satt2 = SpatialAttBridge()
        self.satt3 = SpatialAttBridge()
        self.catt = ChannelAttBridge(c_list)

    def forward(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        n = self.n
        b33 = [conv2d(getattr(self, f"conv1_1_{i + 1}"), ts[i]) for i in range(n)]
        b13 = [conv2d(getattr(self, f"conv1_3_{i + 1}"), ts[i]) for i in range(n)]
        b31 = [conv2d(getattr(self, f"conv3_1_{i + 1}"), ts[i]) for i in range(n)]
        s1, s2, s3 = self.satt(b33), self.satt2(b13), self.satt3(b31)
        r = [self.alpha1 * s1[i] * b33[i] + self.alpha2 * s2[i] * b13[i]
             + self.alpha3 * s3[i] * b31[i] for i in range(n)]
        t_new = [r[i] + ts[i] for i in range(n)]
        catt = self.catt(t_new)
        return [catt[i] * t_new[i] + r[i] for i in range(n)]


class Mamba_UNet(nn.Module):
    """(B, H, W, input_frames) -> (B, H, W, predicted_frames); H and W
    multiples of 32 (five 2x2 poolings). ``seq_mesh`` (a ``parallel.Mesh``)
    runs every DMFM's scan sequence-parallel over its 'spatial' axis
    (``ops/scan.py::selective_scan_sharded``), as the JAX field does."""

    def __init__(self, predicted_frames: int = 3, c_list: Sequence[int] = (8, 16, 24, 32, 48, 64),
                 bridge: bool = True, input_frames: int = 5, seq_mesh=None):
        super().__init__()
        c = list(c_list)
        dmfm = functools.partial(DMFMLayer, seq_mesh=seq_mesh)
        self.bridge = bridge
        self.encoder1 = _conv(input_frames, c[0], 3)
        self.encoder2 = _conv(c[0], c[1], 3)
        self.encoder3 = _conv(c[1], c[2], 3)
        self.encoder4 = dmfm(c[2], c[3])
        self.encoder5 = dmfm(c[3], c[4])
        self.encoder6 = dmfm(c[4], c[5])
        for i, f in enumerate(c, 1):
            setattr(self, f"ebn{i}", _group_norm(f))
        if bridge:
            self.scab = MultiScaleSTAMBridge(c[:5])
        self.decoder1 = dmfm(c[5], c[4])
        self.decoder2 = dmfm(c[4], c[3])
        self.decoder3 = dmfm(c[3], c[2])
        self.decoder4 = _conv(c[2], c[1], 3)
        self.decoder5 = _conv(c[1], c[0], 3)
        self.final = nn.Conv2d(c[0], c[0], 1)
        for i, f in enumerate((c[4], c[3], c[2], c[1], c[0], c[0], c[0]), 1):
            setattr(self, f"dbn{i}", _group_norm(f))
        for i, f in enumerate((c[3], c[2], c[1], c[0], c[0]), 1):
            setattr(self, f"contr{i}", _up(f))
        self.refine1 = dmfm(c[0], c[1])
        self.refine2 = dmfm(c[1], c[2])
        self.refine3 = dmfm(c[2], c[1])
        self.refine4 = dmfm(c[1], c[0])
        self.S1 = _conv(c[0], predicted_frames, 3)
        self.S = _conv(predicted_frames, predicted_frames, 3)
        self.beta = nn.Parameter(torch.ones(()))
        self.row_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, input_frames) -> (B, H, W, predicted_frames). With a
        row axis, H is this rank's block of rows."""
        with sharded_rows(self.row_axis):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        xin = x.permute(0, 3, 1, 2)

        def layer(name, y):  # a conv through its row halo; a DMFM on the rank's tokens
            m = getattr(self, name)
            return conv2d(m, y) if isinstance(m, nn.Conv2d) else m(y)

        def norm(name, y):
            return group_norm(getattr(self, name), y)

        def up(i, y):
            return conv_transpose2d(getattr(self, f"contr{i}"), y)

        def enc(y, i, pool=True):
            y = norm(f"ebn{i}", layer(f"encoder{i}", y))
            return F.gelu(F.max_pool2d(y, 2) if pool else y)

        t1 = enc(xin, 1)
        t2 = enc(t1, 2)
        t3 = enc(t2, 3)
        t4 = enc(t3, 4)
        out = t5 = enc(t4, 5)
        if self.bridge:
            t1, t2, t3, t4, t5 = self.scab([t1, t2, t3, t4, t5])
        out = enc(out, 6, pool=False)

        out5 = F.gelu(norm("dbn1", self.decoder1(out))) + t5
        out4 = F.gelu(up(1, norm("dbn2", self.decoder2(out5)))) + t4
        out3 = F.gelu(up(2, norm("dbn3", self.decoder3(out4)))) + t3
        out2 = F.gelu(up(3, norm("dbn4", layer("decoder4", out3)))) + t2
        out1 = F.gelu(up(4, norm("dbn5", layer("decoder5", out2)))) + t1
        out0 = F.gelu(up(5, norm("dbn6", self.final(out1))))

        y = self.refine4(self.refine3(self.refine2(self.refine1(out0))))
        out0 = F.gelu(norm("dbn7", y))
        out0 = layer("S1", out0) + xin[:, -1:]  # the last input frame, to every output frame
        out0 = layer("S", out0)
        return (out0 * torch.sigmoid(self.beta * out0)).permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation with the JAX package's distributions: every
    conv, transposed conv and linear weight PyTorch's default
    kaiming-uniform (fan-in counted as flax counts it for its kernel) with a
    zero bias; then the MambaBlocks' and the channel bridge's own rules.
    Norms and the 0-d scales keep the ones and zeros of their constructors."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            kaiming_uniform_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_weights_"):
            m.init_weights_(generator)
    return model
