"""Basic blocks (port of ``kmunet_tpu/nn/layers.py``), NCHW."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.parallel.collectives import all_reduce_sum


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis (dim 1) of an NCHW or (B, C, L) tensor:
    biased variance, per-channel affine ``weight`` and ``bias``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = (x - mean).square().mean(dim=1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)


def same_padding(kernel_size) -> tuple[int, int]:
    """Symmetric padding of flax's ``padding='SAME'`` at stride 1, odd kernels."""
    kh, kw = kernel_size
    return kh // 2, kw // 2


def batch_norm_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
                     channel_dim: int = 1) -> torch.Tensor:
    """BatchNorm in training as flax's ``nn.BatchNorm(momentum=0.9)`` computes
    it, with ``bn``'s affine parameters, eps and running buffers.

    The statistics are taken over every axis but ``channel_dim``, in fp32 for
    16-bit inputs, with the biased variance ``E[x^2] - E[x]^2`` (clamped at
    0); the input is normalised with it in fp32 and the result cast back to
    ``x``'s dtype. The running buffers move to ``(1 - m) * running + m *
    batch`` (``m = bn.momentum``, 0.1 = flax's 1 - 0.9) with the same biased
    variance, in place and in fp32. ``F.batch_norm`` with ``training=True``
    would update them with the unbiased variance.

    In a data-parallel run (``set_data_axis``: ``bn.data_axis``) the
    statistics are the global batch's, as flax's under GSPMD: each rank's
    mean of x and of x^2 is summed over the data axis, with a collective
    whose backward sums the gradients, and divided by its size (every rank
    holds as many rows), so every rank's running buffers move alike.
    """
    channel_dim %= x.dim()
    dims = [d for d in range(x.dim()) if d != channel_dim]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean, mean_sq = xf.mean(dims), xf.square().mean(dims)
    axis = getattr(bn, "data_axis", None)
    if axis is not None:
        mean, mean_sq = (all_reduce_sum(torch.stack([mean, mean_sq]), axis) / axis.size).unbind()
    var = (mean_sq - mean.square()).clamp_min(0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach().to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach().to(bn.running_var.dtype), alpha=m)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    y = (xf - mean.view(shape)) * (torch.rsqrt(var + bn.eps) * bn.weight).view(shape)
    return (y + bn.bias.view(shape)).to(x.dtype)


class ConvBNAct(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-5), optional activation. The
    BatchNorm runs on its running statistics in eval mode and as flax's in
    training (``batch_norm_train``).

    ``bn_weight_init`` is the initial BN scale (0 makes a residual branch
    start as the identity).
    """

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3), groups: int = 1,
                 bn_weight_init: float = 1.0, act: Optional[Callable] = F.relu):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size,
                                padding=same_padding(kernel_size), groups=groups, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        nn.init.constant_(self.BatchNorm_0.weight, bn_weight_init)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        x = batch_norm_train(x, self.BatchNorm_0) if self.training else self.BatchNorm_0(x)
        return self.act(x) if self.act is not None else x


class FFN(nn.Module):
    """1x1 conv MLP: expand (BN + ReLU), then project (BN scale init 0)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(channels, hidden, (1, 1))
        self.ConvBNAct_1 = ConvBNAct(hidden, channels, (1, 1), act=None, bn_weight_init=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvBNAct_1(self.ConvBNAct_0(x))


class DropPath(nn.Module):
    """Stochastic depth over the batch axis; the identity in eval mode.

    In training each sample is kept with probability ``1 - rate`` (one draw
    per sample from ``generator``, which lies on ``x``'s device) and a kept
    sample is scaled by ``1 / (1 - rate)``, as ``kmunet_tpu/nn/layers.py``'s
    ``DropPath`` does. There is no global random state: training with
    ``rate > 0`` needs the caller's generator. In a data-parallel run
    (``set_data_axis``) the mask is drawn for the global batch and this rank
    keeps its block of it, so every rank's generator moves as the one
    process's would.
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.data_axis = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training draws from a torch.Generator: pass one")
        keep = 1.0 - self.rate
        rows, axis = x.shape[0], self.data_axis
        shape = (rows * (1 if axis is None else axis.size),) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        if axis is not None:
            mask = mask[axis.index * rows:(axis.index + 1) * rows]
        return torch.where(mask, x / keep, 0.0)


def set_data_axis(model: nn.Module, axis) -> nn.Module:
    """Makes ``model``'s train-mode BatchNorms take their statistics over the
    data axis ``axis`` (a ``parallel.mesh.Axis``; None: this rank's rows
    alone) and its DropPaths draw the global batch's mask."""
    for m in model.modules():
        if isinstance(m, (nn.modules.batchnorm._BatchNorm, DropPath)):
            m.data_axis = axis
    return model
