"""Basic blocks (port of ``kmunet_tpu/nn/layers.py``), NCHW."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.parallel.collectives import all_reduce_sum
from kmunet_tpu_torch.parallel.halo import conv2d


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


def pad_same(x: torch.Tensor, kernel_size, stride) -> torch.Tensor:
    """``x`` (NCHW) padded as XLA's ``padding='SAME'`` pads it for a conv of
    ``kernel_size`` at ``stride``: ``max((ceil(n / s) - 1) * s + k - n, 0)``
    zeros per axis, the odd one after (so a strided conv takes padding 0)."""
    pads = []
    sizes = zip(x.shape[2:], tuple(kernel_size), tuple(stride))
    for n, k, s in reversed(list(sizes)):  # F.pad takes the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


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
    holds as many elements), so every rank's running buffers move alike.
    Where the image rows are sharded too (``bn.centred``, the data x spatial
    axis) the variance is the centred second pass's, the mean of (x -
    mean)^2 summed over the axis after the mean: on the small SH config in
    fp32 under sp2, E[x^2] - E[x]^2 put the step-1 gradients up to 1.5e-4
    off float64 (1.3 % of the largest gradient of the bridge's final conv),
    the centred pass 2.0e-7, as close as one process's E[x^2] - E[x]^2.
    """
    channel_dim %= x.dim()
    dims = [d for d in range(x.dim()) if d != channel_dim]
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axis = getattr(bn, "data_axis", None)
    if axis is not None and getattr(bn, "centred", False):
        mean = all_reduce_sum(xf.mean(dims), axis) / axis.size
        var = all_reduce_sum((xf - mean.view(shape)).square().mean(dims), axis) / axis.size
    else:
        mean, mean_sq = xf.mean(dims), xf.square().mean(dims)
        if axis is not None:
            mean, mean_sq = (all_reduce_sum(torch.stack([mean, mean_sq]), axis)
                             / axis.size).unbind()
        var = (mean_sq - mean.square()).clamp_min(0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach().to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach().to(bn.running_var.dtype), alpha=m)
    y = (xf - mean.view(shape)) * (torch.rsqrt(var + bn.eps) * bn.weight).view(shape)
    return (y + bn.bias.view(shape)).to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """flax's ``nn.BatchNorm(use_running_average=not train)``: in training
    (``bn.training``) ``batch_norm_train``, else ``bn`` on its running
    statistics."""
    return batch_norm_train(x, bn) if bn.training else bn(x)


class ConvBNAct(nn.Module):
    """Bias-free conv, BatchNorm (eps 1e-5), optional activation. The
    BatchNorm runs on its running statistics in eval mode and as flax's in
    training (``batch_norm_train``).

    ``bn_weight_init`` is the initial BN scale (0 makes a residual branch
    start as the identity). ``stride`` > 1 pads as flax's ``SAME`` does
    (``pad_same``: at an even size the one row and column after, none
    before), not symmetrically. At stride 1 the rows are padded from the
    neighbouring ranks where the image rows are sharded (``halo.conv2d``).
    """

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3), groups: int = 1,
                 bn_weight_init: float = 1.0, act: Optional[Callable] = F.relu, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel_size, stride=stride,
                                padding=same_padding(kernel_size) if stride == 1 else 0,
                                groups=groups, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
        nn.init.constant_(self.BatchNorm_0.weight, bn_weight_init)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride != 1:
            x = pad_same(x, self.Conv_0.kernel_size, (self.stride, self.stride))
            x = self.Conv_0(x)
        else:
            x = conv2d(self.Conv_0, x)
        x = batch_norm(x, self.BatchNorm_0)
        return self.act(x) if self.act is not None else x


class Conv1x1(nn.Module):
    """A plain 1x1 conv (bias optional), flax's ``Conv1x1`` wrapper."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x)


class SqueezeExcite(nn.Module):
    """timm-style SE: the spatial mean through a 1x1 conv to
    ``max(1, int(C * rd_ratio))`` channels, ReLU, a 1x1 conv back to C and a
    sigmoid gate on x."""

    def __init__(self, channels: int, rd_ratio: float = 0.25):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.Conv_0 = nn.Conv2d(channels, rd, 1)
        self.Conv_1 = nn.Conv2d(rd, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.Conv_1(F.relu(self.Conv_0(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class Stem(nn.Module):
    """The 16x downsampling stem: four strided 3x3 ConvBNActs to dim / 8,
    dim / 4, dim / 2 (ReLU) and dim (none), flax's ``SAME`` padding."""

    def __init__(self, in_channels: int, dim: int = 96):
        super().__init__()
        widths = (in_channels, dim // 8, dim // 4, dim // 2, dim)
        for i in range(4):
            setattr(self, f"ConvBNAct_{i}",
                    ConvBNAct(widths[i], widths[i + 1], (3, 3), stride=2,
                              act=F.relu if i < 3 else None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        return x


class PatchMerging(nn.Module):
    """The SE-augmented 2x downsampling merge: a depthwise 3x3 residual, a
    1x1 expand to ``out_dim * ratio``, a strided depthwise 3x3 (flax's
    ``SAME``), SE, a 1x1 project to ``out_dim`` and a depthwise 3x3
    residual."""

    def __init__(self, in_dim: int, out_dim: int, ratio: float = 4.0):
        super().__init__()
        hidden = int(out_dim * ratio)
        self.ConvBNAct_0 = ConvBNAct(in_dim, in_dim, (3, 3), groups=in_dim, act=None)
        self.ConvBNAct_1 = ConvBNAct(in_dim, hidden, (1, 1))
        self.ConvBNAct_2 = ConvBNAct(hidden, hidden, (3, 3), groups=hidden, stride=2)
        self.SqueezeExcite_0 = SqueezeExcite(hidden)
        self.ConvBNAct_3 = ConvBNAct(hidden, out_dim, (1, 1), act=None)
        self.ConvBNAct_4 = ConvBNAct(out_dim, out_dim, (3, 3), groups=out_dim, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ConvBNAct_0(x)
        y = self.ConvBNAct_2(self.ConvBNAct_1(x))
        y = self.ConvBNAct_3(self.SqueezeExcite_0(y))
        return y + self.ConvBNAct_4(y)


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

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        """The mask's shape past the batch axis: one draw per sample."""
        return (1,) * (x.dim() - 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(f"{type(self).__name__} in training draws from a torch.Generator: "
                             "pass one")
        keep = 1.0 - self.rate
        rows, axis = x.shape[0], self.data_axis
        shape = (rows * (1 if axis is None else axis.size),) + self._mask_shape(x)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        if axis is not None:
            mask = mask[axis.index * rows:(axis.index + 1) * rows]
        return torch.where(mask, x / keep, 0.0)


class Dropout(DropPath):
    """flax's ``nn.Dropout(rate)``: ``DropPath`` with one draw per element
    (``torch.nn.Dropout`` draws from the global generator; this one from
    the caller's)."""

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape[1:])


def set_data_axis(model: nn.Module, axis, norm_axis=None) -> nn.Module:
    """Makes ``model``'s train-mode BatchNorms take their statistics over
    ``norm_axis`` (default ``axis``; data x spatial where the image rows are
    sharded, with the centred variance: ``batch_norm_train``) and its
    DropPaths (and Dropouts) draw the global batch's mask over the data axis
    ``axis`` (``parallel.mesh.Axis``es; None: this rank's rows alone), the
    same mask on every spatial rank of a data index."""
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.data_axis = axis if norm_axis is None else norm_axis
            m.centred = norm_axis is not None
        elif isinstance(m, DropPath):
            m.data_axis = axis
    return model
