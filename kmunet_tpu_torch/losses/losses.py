"""Nowcasting losses (port of ``kmunet_tpu/losses/losses.py``).

``hybrid_loss`` (the SH training loss), ``weighted_mse_mae`` (the ConvLSTM
and TrajGRU recipes'), ``rainfall_loss`` (Mamba-UNet's) and ``rain_loss``
(the other zoo recipes') are ported; ``en_rainfall_loss`` waits for ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kmunet_tpu_torch.ops.ssim import ssim_valid


def hybrid_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.7) -> torch.Tensor:
    """KM-UNet's training loss: weighted MSE mix + SSIM on min-max-normalized
    maps. pred/target: (B, T, H, W) -- SSIM treats the two trailing axes as
    the image. The min/max bounds carry no gradient (``.detach()``, the
    reference's stop-gradient)."""
    mse = torch.mean((pred - target) ** 2)

    weight_map = torch.exp(target * 2.0)  # emphasize heavy rainfall
    weighted = torch.mean((pred - target) ** 2 * weight_map)

    t_min, t_max = target.min().detach(), target.max().detach()
    p_min, p_max = pred.min().detach(), pred.max().detach()
    t_norm = (target - t_min) / (t_max - t_min + 1e-8)
    p_norm = (pred - p_min) / (p_max - p_min + 1e-8)
    ssim = torch.mean(ssim_valid(p_norm, t_norm, data_range=1.0))
    ssim_loss = 1.0 - ssim

    return alpha * (0.55 * mse + 0.45 * weighted) + (1.0 - alpha) * ssim_loss


def rainfall_loss(pred: torch.Tensor, target: torch.Tensor, omega_t: float = 0.57,
                  alpha: float = 0.25) -> torch.Tensor:
    """Dynamic quantile weighted L1 with exp emphasis above 0.7: over- and
    under-predictions weighted 1 - 0.57 and 0.57, plus, where the target is
    at least 0.7, ``alpha * exp(target)`` times 1 - omega_t and omega_t;
    both sums divided by the number of elements."""
    w0 = 0.57
    err = (pred - target).abs()
    ge = (pred >= target).to(pred.dtype)
    lt = 1.0 - ge
    heavy = (target >= 0.7).to(pred.dtype)
    wi = alpha * torch.exp(target)
    base = torch.sum(ge * (1 - w0) * err) + torch.sum(lt * w0 * err)
    quant = (torch.sum(ge * heavy * (1 - omega_t) * wi * err)
             + torch.sum(lt * heavy * omega_t * wi * err))
    n = pred.numel()
    return base / n + quant / n


def rain_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE + MAE."""
    return torch.mean((pred - target) ** 2) + torch.mean((pred - target).abs())


def weighted_mse_mae(pred: torch.Tensor, target: torch.Tensor, mse_weight: float = 1.0,
                     mae_weight: float = 1.0, global_scale: float = 0.00005,
                     lam: Optional[float] = None,
                     thresholds: Sequence[float] = ()) -> torch.Tensor:
    """Rainfall-threshold-banded weights (1, 1, 2, 5, 10, 30) and an optional
    per-timestep ramp ``1 + lam * s``. pred/target: (B, S, C, H, W); the
    squared and absolute errors are summed over (C, H, W) for each (S, B)
    and averaged."""
    balancing = (1.0, 1.0, 2.0, 5.0, 10.0, 30.0)
    weights = torch.full_like(pred, balancing[0])
    for i, thr in enumerate(thresholds):
        weights = weights + (balancing[i + 1] - balancing[i]) * (target >= thr).to(pred.dtype)
    diff = pred - target
    mse = torch.sum(weights * diff ** 2, dim=(2, 3, 4))  # (B, S)
    mae = torch.sum(weights * diff.abs(), dim=(2, 3, 4))
    if lam is not None:
        w = 1.0 + lam * torch.arange(mse.shape[1], dtype=mse.dtype, device=mse.device)
        mse, mae = mse * w, mae * w
    return global_scale * (mse_weight * torch.mean(mse) + mae_weight * torch.mean(mae))
