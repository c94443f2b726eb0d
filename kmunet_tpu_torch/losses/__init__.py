"""Losses of the port."""

from kmunet_tpu_torch.losses.losses import hybrid_loss, weighted_mse_mae

__all__ = ["hybrid_loss", "weighted_mse_mae"]
