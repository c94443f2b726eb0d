"""Gaussian-window SSIM over the valid region (port of ``kmunet_tpu/ops/ssim.py``).

An 11x11 Gaussian (sigma 1.5) applied as a VALID separable filter, as the
reference's evaluation metric and the SSIM inside HybridLoss both compute
it. The filter is two banded matrix products: they run in full fp32 on the
card by default (``torch.backends.cuda.matmul.allow_tf32`` is False), as the
JAX package asks for HIGHEST precision, where a cuDNN fp32 convolution would
run in TF32.
"""

from __future__ import annotations

import torch


def gaussian_kernel_1d(size: int = 11, sigma: float = 1.5, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """cv2.getGaussianKernel-compatible normalized 1D Gaussian."""
    half = (size - 1) / 2.0
    x = torch.arange(size, dtype=dtype, device=device) - half
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _band(size: int, k1d: torch.Tensor) -> torch.Tensor:
    """(size - n + 1, size) matrix whose row o holds ``k1d`` at columns o..o+n-1."""
    n = k1d.shape[0]
    out = size - n + 1
    cols = torch.arange(out, device=k1d.device)[:, None] + torch.arange(n, device=k1d.device)
    return torch.zeros(out, size, dtype=k1d.dtype, device=k1d.device).scatter_(
        1, cols, k1d.expand(out, n))


def _filter_valid(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable VALID Gaussian filtering of ``(N, H, W)`` images."""
    k1d = k1d.to(img.dtype)
    H, W = img.shape[-2:]
    return _band(H, k1d) @ img @ _band(W, k1d).T


def ssim_valid(
    pred: torch.Tensor,
    true: torch.Tensor,
    data_range: float,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over the valid (un-padded) interior, per leading-batch image.

    ``pred``, ``true``: ``(..., H, W)``, computed in fp32; returns ``(...,)``.
    ``data_range`` is the inputs' dynamic range (1.0 inside HybridLoss).
    """
    lead = pred.shape[:-2]
    H, W = pred.shape[-2:]
    p = pred.reshape(-1, H, W).float()
    t = true.reshape(-1, H, W).float()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    k1d = gaussian_kernel_1d(kernel_size, sigma, device=p.device)

    # The five maps filtered in one pair of products.
    mu1, mu2, pp, tt, pt = _filter_valid(torch.stack([p, t, p * p, t * t, p * t]), k1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = pp - mu1_sq
    sigma2_sq = tt - mu2_sq
    sigma12 = pt - mu1_mu2

    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean(dim=(-2, -1)).reshape(lead)
