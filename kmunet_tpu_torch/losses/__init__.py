"""Losses of the port."""

from kmunet_tpu_torch.losses.losses import hybrid_loss

__all__ = ["hybrid_loss"]
