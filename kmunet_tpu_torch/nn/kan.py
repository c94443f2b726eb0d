"""KAN convolution (port of ``kmunet_tpu/nn/kan.py::KANConv2d``).

    KANConv2d(x) = conv(silu(xp), base) + conv(B(xp), spline * scaler)

with ``xp`` the zero-padded input and ``B`` the cubic B-spline basis (8
functions per channel on a uniform grid over [-1, 1]). The input is padded
*before* the basis is evaluated, because basis(0) != 0. The function is
``kernels/kanconv.py``'s: its plain version by default, ``fused_kanconv``
(K1 on the card) with ``fused=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.kernels.kanconv import fused_kanconv, kanconv_plain
from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.ops.spline import bspline_basis, knots


class KANConv2d(nn.Module):
    """Stride-1 KAN conv on NCHW tensors.

    Parameters, in PyTorch layout: ``base_weight`` (F, C, k, k),
    ``spline_weight`` (F, C, n, k, k) and ``spline_scaler`` (F, C, k, k), with
    ``n = grid_size + 3`` bases per channel. ``fused=True`` computes the
    same function through ``fused_kanconv`` (K1 on the card), which takes a
    3x3 kernel on the grid of 5 cubic intervals only.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 0, grid_size: int = 5, spline_order: int = 3,
                 scale_noise: float = 0.1, fused: bool = False):
        super().__init__()
        k = kernel_size
        if fused and (k, grid_size, spline_order) != (3, 5, 3):
            raise ValueError("fused=True takes kernel_size 3, grid_size 5 and spline_order 3, "
                             f"got {(k, grid_size, spline_order)}")
        self.fused = fused
        self.padding = padding
        self.grid_size = grid_size
        self.spline_order = spline_order
        self.scale_noise = scale_noise
        n_basis = grid_size + spline_order
        self.base_weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.spline_weight = nn.Parameter(torch.empty(features, in_channels, n_basis, k, k))
        self.spline_scaler = nn.Parameter(torch.empty(features, in_channels, k, k))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.base_weight, generator)
        kaiming_uniform_(self.spline_scaler, generator)
        # Fit the spline to small uniform noise at the interior grid points
        # (min-norm least squares), as the JAX package's _spline_noise_init.
        F_, C, n_basis, k, _ = self.spline_weight.shape
        g = self.grid_size
        kn = knots(g, self.spline_order)
        interior = kn[self.spline_order:-self.spline_order]
        basis = bspline_basis(interior[:, None], kn[None, :], self.spline_order)[:, 0, :]
        noise = (torch.rand(g + 1, k * k * C, F_, generator=generator) - 0.5) * (self.scale_noise / g)
        coeff = torch.einsum("bg,gfo->fbo", torch.linalg.pinv(basis), noise)  # (kkC, n, F)
        coeff = coeff.reshape(k, k, C, n_basis, F_).permute(4, 2, 3, 0, 1)
        self.spline_weight.copy_(coeff)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        xp = F.pad(x, (p, p, p, p)) if p else x
        F_, C, n_basis, k, _ = self.spline_weight.shape
        sk = (self.spline_weight * self.spline_scaler[:, :, None]).reshape(F_, C * n_basis, k, k)
        if self.fused:
            return fused_kanconv(xp, self.base_weight, sk)
        return kanconv_plain(xp, self.base_weight, sk, self.grid_size, self.spline_order)
