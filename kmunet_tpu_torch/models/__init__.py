"""Models of the port."""

from kmunet_tpu_torch.models.ef import ConvLSTM_EF, TrajGRU_EF
from kmunet_tpu_torch.models.km_unet import KM_UNetV3, KM_UNetV3_SH

__all__ = ["ConvLSTM_EF", "KM_UNetV3", "KM_UNetV3_SH", "TrajGRU_EF"]
