"""Losses of the port."""

from kmunet_tpu_torch.losses.losses import (
    hybrid_loss,
    rain_loss,
    rainfall_loss,
    weighted_mse_mae,
)

__all__ = ["hybrid_loss", "rain_loss", "rainfall_loss", "weighted_mse_mae"]
