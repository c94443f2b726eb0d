"""Models of the port."""

from kmunet_tpu_torch.models.km_unet import KM_UNetV3, KM_UNetV3_SH

__all__ = ["KM_UNetV3", "KM_UNetV3_SH"]
