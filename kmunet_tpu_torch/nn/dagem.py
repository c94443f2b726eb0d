"""DAGEM bridge (port of ``kmunet_tpu/nn/dagem.py``).

The H x W grid is a graph with 4-neighbour edges from *circular* shifts:

    edge[.., k]      = roll_k(x) * x                       (4 directions)
    aggregated_edge  = MLP_{4->1}(edge rows)
    update_vertex    = MLP_{2C->C/2}([x, aggregated_edge])
    update_edge      = MLP_{4->1}(MLP_{2C->C/2}([x, edge_k]) per direction)
    deform branch    = DeformConv3x3(x, offsets=Conv3x3(x)) + x
    out              = Conv1x1 + BN + ReLU([deform, update_vertex * update_edge])

The row MLPs act on the last axis, so the module works in NHWC inside.
Where the image rows are sharded (``parallel/halo.py``) the rolls along H
read one row of a ring halo (the reference wraps), the offset conv reads
its neighbours' rows, the deformable conv gathers from the whole image,
and the row MLPs' BatchNorms take the statistics of data x spatial.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.nn.layers import ConvBNAct, batch_norm_train
from kmunet_tpu_torch.nn.resample import DeformConv2d
from kmunet_tpu_torch.parallel.halo import conv2d, halo_rows, row_axis


class _RowMLP(nn.Module):
    """Linear + BatchNorm over the last axis (flax's in training) + ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.BatchNorm_0 = nn.BatchNorm1d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(x)
        if self.training:
            return F.relu(batch_norm_train(y, self.BatchNorm_0, channel_dim=-1))
        return F.relu(self.BatchNorm_0(y.reshape(-1, y.shape[-1])).reshape(y.shape))


class DAGEM(nn.Module):
    """Graph-edge-aggregation bridge with a deformable-conv branch, NCHW in and out."""

    def __init__(self, channels: int):
        super().__init__()
        C = channels
        self.edge_aggregation = _RowMLP(4, 1)
        self.vertex_update = _RowMLP(2 * C, C // 2)
        self.edge_update = _RowMLP(2 * C, C // 2)
        self.edge_reduce = _RowMLP(4, 1)
        self.offset_conv = nn.Conv2d(C, 18, 3, padding=1)
        self.deform_conv = DeformConv2d(C, C)
        self.final_aggregation = ConvBNAct(C + C // 2, C, (1, 1))

    def forward(self, x_nchw: torch.Tensor) -> torch.Tensor:
        x = x_nchw.permute(0, 2, 3, 1)  # (B, H, W, C)
        axis = row_axis()
        if axis is None:
            up, down = x.roll(1, 1), x.roll(-1, 1)
        else:
            ring = halo_rows(x, axis, 1, 1, mode="wrap", dim=1)
            up, down = ring[:, :-2], ring[:, 2:]
        edge = torch.stack(
            [up, down, x.roll(1, 2), x.roll(-1, 2)], dim=-1
        ) * x[..., None]  # (B, H, W, C, 4)
        aggregated_edge = self.edge_aggregation(edge)[..., 0]
        update_vertex = self.vertex_update(torch.cat([x, aggregated_edge], dim=-1))
        # Per direction, a row [x, edge_k] of 2C features.
        edge_rows = torch.cat([x[..., None].expand(edge.shape), edge], dim=-2).transpose(-1, -2)
        upd = self.edge_update(edge_rows).transpose(-1, -2)  # (B, H, W, C/2, 4)
        update_edge = self.edge_reduce(upd)[..., 0]
        update_feature = update_vertex * update_edge

        offset = conv2d(self.offset_conv, x_nchw).permute(0, 2, 3, 1)
        deformed = self.deform_conv(x, offset) + x
        combined = torch.cat([deformed, update_feature], dim=-1).permute(0, 3, 1, 2)
        return self.final_aggregation(combined)
