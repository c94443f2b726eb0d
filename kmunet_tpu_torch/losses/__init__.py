"""Losses of the port."""

from kmunet_tpu_torch.losses.losses import (
    en_rainfall_loss,
    hybrid_loss,
    rain_loss,
    rainfall_loss,
    weighted_mse_mae,
)

__all__ = ["en_rainfall_loss", "hybrid_loss", "rain_loss", "rainfall_loss", "weighted_mse_mae"]
