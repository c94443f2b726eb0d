"""B-spline bases for the KAN layers (port of ``kmunet_tpu/ops/spline.py``)."""

from __future__ import annotations

import torch


def knots(grid_size: int = 5, spline_order: int = 3, grid_range=(-1.0, 1.0)) -> torch.Tensor:
    """Uniform extended knot vector, ``grid_size + 2*order + 1`` knots."""
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    return torch.arange(-spline_order, grid_size + spline_order + 1, dtype=torch.float32) * h + lo


def bspline_basis(x: torch.Tensor, grid: torch.Tensor, spline_order: int = 3) -> torch.Tensor:
    """Cox-de-Boor basis: ``x`` (..., F), ``grid`` (F or 1, K) -> (..., F, K-1-order).

    The degree-0 seed is the half-open interval indicator ``g_i <= x < g_i+1``.
    """
    x = x[..., None]
    bases = ((x >= grid[:, :-1]) & (x < grid[:, 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - grid[:, : -(k + 1)]) / (grid[:, k:-1] - grid[:, : -(k + 1)])
        right = (grid[:, k + 1:] - x) / (grid[:, k + 1:] - grid[:, 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


def cardinal_bspline_basis_flat(
    x: torch.Tensor, grid_size: int = 5, spline_order: int = 3, grid_range=(-1.0, 1.0)
) -> torch.Tensor:
    """Uniform-grid cubic basis of an NCHW tensor: (B, C, H, W) -> (B, C*n, H, W).

    ``n = grid_size + 3`` bases per channel, c-major: channel ``c*n + b``
    holds basis ``b`` of input channel ``c``. Every basis is a shift of the
    cubic cardinal B-spline M4 (support [0, 4)), with the half-open piece
    intervals of the Cox-de-Boor seed.
    """
    if spline_order != 3:
        raise NotImplementedError("the cardinal basis implements cubic splines only")
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    n_basis = grid_size + spline_order
    B, C, H, W = x.shape
    u = (x - lo) / h + spline_order  # basis b is supported on u in [b, b+4)
    shifts = torch.arange(n_basis, dtype=x.dtype, device=x.device).view(1, 1, n_basis, 1, 1)
    t = (u[:, :, None] - shifts).reshape(B, C * n_basis, H, W)
    t2 = t * t
    t3 = t2 * t
    p0 = t3 * (1.0 / 6.0)
    p1 = (-3.0 * t3 + 12.0 * t2 - 12.0 * t + 4.0) * (1.0 / 6.0)
    p2 = (3.0 * t3 - 24.0 * t2 + 60.0 * t - 44.0) * (1.0 / 6.0)
    p3 = (4.0 - t) ** 3 * (1.0 / 6.0)
    out = torch.where(t < 1.0, p0, torch.where(t < 2.0, p1, torch.where(t < 3.0, p2, p3)))
    return torch.where((t >= 0.0) & (t < 4.0), out, torch.zeros((), dtype=x.dtype, device=x.device))
