"""Models of the port."""

from kmunet_tpu_torch.models.ef import ConvLSTM_EF, TrajGRU_EF
from kmunet_tpu_torch.models.km_unet import KM_UNetV3, KM_UNetV3_LAPS, KM_UNetV3_SH
from kmunet_tpu_torch.models.mamba_unet import Mamba_UNet

__all__ = ["ConvLSTM_EF", "KM_UNetV3", "KM_UNetV3_LAPS", "KM_UNetV3_SH", "Mamba_UNet",
           "TrajGRU_EF"]
