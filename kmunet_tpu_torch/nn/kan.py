"""KAN layers (port of ``kmunet_tpu/nn/kan.py``).

    KANLinear(x) = silu(x) @ base + B(x) @ (spline * scaler)
    KANConv2d(x) = conv(silu(xp), base) + conv(B(xp), spline * scaler)

with ``B`` the B-spline basis (8 cubic functions per feature on a uniform
grid over [-1, 1]) and ``xp`` the zero-padded input: the conv pads *before*
the basis is evaluated, because basis(0) != 0. The conv's function is
``kernels/kanconv.py``'s: its plain version by default, ``fused_kanconv``
(K1 on the card) with ``fused=True``. Both layers keep the basis axis of
``spline_weight`` at dim 2, which ``kan_regularization_loss`` reduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.kernels.kanconv import fused_kanconv, kanconv_plain
from kmunet_tpu_torch.nn.init import kaiming_uniform_
from kmunet_tpu_torch.ops.spline import bspline_basis, knots, pinv
from kmunet_tpu_torch.parallel.halo import halo_rows, row_axis


def spline_noise_coeff(generator: torch.Generator, n_feat: int, out: int, grid_size: int,
                       spline_order: int, scale_noise: float) -> torch.Tensor:
    """The JAX package's curve2coeff-style init (``_spline_noise_init``):
    the spline coefficients, (n_feat, grid_size + order, out), that fit
    small uniform noise at the interior grid points by min-norm least
    squares."""
    kn = knots(grid_size, spline_order)
    interior = kn[spline_order:-spline_order]
    basis = bspline_basis(interior[:, None], kn[None, :], spline_order)[:, 0, :]
    noise = (torch.rand(grid_size + 1, n_feat, out, generator=generator) - 0.5) * (
        scale_noise / grid_size)
    return torch.einsum("bg,gfo->fbo", pinv(basis), noise)


class KANLinear(nn.Module):
    """Spline-KAN dense layer over the trailing feature axis.

    Parameters, in PyTorch layout: ``base_weight`` (out, in),
    ``spline_weight`` (out, in, n) and ``spline_scaler`` (out, in), with
    ``n = grid_size + spline_order`` bases per input feature; the JAX
    package's are (in, out), (in, n, out) and (in, out). The base branch is
    silu and the grid spans [-1, 1], the JAX layer's defaults.
    """

    def __init__(self, in_features: int, features: int, grid_size: int = 5,
                 spline_order: int = 3, scale_noise: float = 0.1):
        super().__init__()
        self.grid_size = grid_size
        self.spline_order = spline_order
        self.scale_noise = scale_noise
        n_basis = grid_size + spline_order
        self.base_weight = nn.Parameter(torch.empty(features, in_features))
        self.spline_weight = nn.Parameter(torch.empty(features, in_features, n_basis))
        self.spline_scaler = nn.Parameter(torch.empty(features, in_features))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> None:
        kaiming_uniform_(self.base_weight, generator)
        out, n_in, _ = self.spline_weight.shape
        coeff = spline_noise_coeff(generator, n_in, out, self.grid_size, self.spline_order,
                                   self.scale_noise)
        self.spline_weight.copy_(coeff.permute(2, 0, 1))
        kaiming_uniform_(self.spline_scaler, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, n_in, n_basis = self.spline_weight.shape
        kn = knots(self.grid_size, self.spline_order).to(x.device, x.dtype)
        base = F.linear(F.silu(x), self.base_weight)
        basis = bspline_basis(x, kn[None, :], self.spline_order)  # (..., in, n)
        scaled = (self.spline_weight * self.spline_scaler[..., None]).reshape(out, n_in * n_basis)
        return base + F.linear(basis.flatten(-2), scaled)


def kan_regularization_loss(params: dict) -> torch.Tensor:
    """Spline L1 + entropy regularizer, summed over every KAN layer, as the
    JAX package's ``kan_regularization_loss`` with its weights of 1 (the
    reference's ``KANLinear.regularization_loss``): per ``spline_weight``
    (KANLinear's and KANConv2d's, basis axis 2 in both), ``l1 =
    |w|.mean(basis axis)``, the activation term ``l1.sum()`` plus the
    entropy term ``-sum(p log p)`` with ``p = l1 / l1.sum()``, on the raw
    spline weight in fp32 (the scaler is left out, as in the reference).
    ``params``: tensors by state_dict name; the others are ignored. 0 when
    none is a spline weight."""
    total = None
    for name, w in params.items():
        if name.rsplit(".", 1)[-1] != "spline_weight":
            continue
        l1 = w.float().abs().mean(dim=2)
        act = l1.sum()
        p = l1 / act
        term = act - (p * torch.log(p)).sum()
        total = term if total is None else total + term
    return torch.zeros(()) if total is None else total


class KANConv2d(nn.Module):
    """Stride-1 KAN conv on NCHW tensors.

    Parameters, in PyTorch layout: ``base_weight`` (F, C, k, k),
    ``spline_weight`` (F, C, n, k, k) and ``spline_scaler`` (F, C, k, k), with
    ``n = grid_size + 3`` bases per channel. ``fused=True`` computes the
    same function through ``fused_kanconv`` (K1 on the card), which takes a
    3x3 kernel on the grid of 5 cubic intervals only. Where the image rows
    are sharded (``parallel/halo.py``) the rows above and below come from
    the neighbours, zeros past the global edges.
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
        F_, C, n_basis, k, _ = self.spline_weight.shape
        coeff = spline_noise_coeff(generator, k * k * C, F_, self.grid_size, self.spline_order,
                                   self.scale_noise)  # (kkC, n, F), JAX's feature order
        self.spline_weight.copy_(coeff.reshape(k, k, C, n_basis, F_).permute(4, 2, 3, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.padding
        axis = row_axis()
        if axis is not None:
            if self.fused:
                raise NotImplementedError("the fused KAN conv (K1) on sharded rows is ROADMAP "
                                          "Queue 1 item 12")
            xp = F.pad(halo_rows(x, axis, p, p), (p, p)) if p else x
        else:
            xp = F.pad(x, (p, p, p, p)) if p else x
        F_, C, n_basis, k, _ = self.spline_weight.shape
        sk = (self.spline_weight * self.spline_scaler[:, :, None]).reshape(F_, C * n_basis, k, k)
        if self.fused:
            return fused_kanconv(xp, self.base_weight, sk)
        return kanconv_plain(xp, self.base_weight, sk, self.grid_size, self.spline_order)
