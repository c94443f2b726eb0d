"""B-spline bases for the KAN layers and the grid refit (port of
``kmunet_tpu/ops/spline.py``)."""

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


def pinv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv``: the pseudo-inverse of (..., m, n) matrices with
    JAX's cutoff, singular values below 10 * max(m, n) * eps of each
    matrix's largest dropped (``torch.linalg.pinv``'s default is max(m, n)
    * eps, which keeps more of a rank-deficient fit's noise)."""
    m, n = a.shape[-2:]
    return torch.linalg.pinv(a, rtol=10.0 * max(m, n) * torch.finfo(a.dtype).eps)


def update_grid(x: torch.Tensor, grid: torch.Tensor, scaled_spline_weight: torch.Tensor,
                spline_order: int = 3, grid_eps: float = 0.02,
                margin: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-fits the knot grid to the samples ``x`` and the spline weights so
    that the function is kept on the samples, as the JAX package's
    ``update_grid`` (the reference's ``KANLinear.update_grid``).

    ``x`` (batch, in); ``grid`` (in, grid_size + 2 * order + 1);
    ``scaled_spline_weight`` (out, in, n) in KANLinear's layout, the spline
    weight times its scaler. Returns the new grid and the new weight in
    the same shapes; the caller resets the scaler to 1. The grid mixes
    each feature's sample quantiles (weight 1 - grid_eps) with a uniform
    grid over their range widened by ``margin``, extended by ``order``
    knots at each end; the weights are each feature's min-norm least
    squares fit (``pinv``, JAX's cutoff) of the old outputs.
    """
    batch, _ = x.shape
    grid_size = grid.shape[1] - 2 * spline_order - 1
    w = scaled_spline_weight.permute(1, 2, 0)  # (in, n, out)
    unreduced = torch.einsum("bif,ifo->bio", bspline_basis(x, grid, spline_order), w)

    x_sorted = torch.sort(x, dim=0).values
    qi = torch.linspace(0, batch - 1, grid_size + 1, dtype=torch.float64).to(torch.int64)
    grid_adaptive = x_sorted[qi]  # (grid_size + 1, in)
    uniform_step = (x_sorted[-1] - x_sorted[0] + 2 * margin) / grid_size
    steps = torch.arange(grid_size + 1, dtype=x.dtype, device=x.device)[:, None]
    grid_uniform = steps * uniform_step + x_sorted[0] - margin
    g = grid_eps * grid_uniform + (1 - grid_eps) * grid_adaptive
    ext = torch.arange(1, spline_order + 1, dtype=x.dtype, device=x.device)[:, None]
    new_grid = torch.cat([g[:1] - uniform_step * ext.flip(0), g, g[-1:] + uniform_step * ext]).T

    A = bspline_basis(x, new_grid, spline_order).transpose(0, 1)  # (in, batch, n)
    new_w = torch.einsum("inb,ibo->ino", pinv(A), unreduced.transpose(0, 1))
    return new_grid, new_w.permute(2, 0, 1)
