"""Nowcasting losses (port of ``kmunet_tpu/losses/losses.py``).

Only ``hybrid_loss``, the SH training loss, is ported so far; the other four
(``rainfall_loss``, ``en_rainfall_loss``, ``rain_loss``,
``weighted_mse_mae``) wait for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

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
