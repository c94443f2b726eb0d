"""Models of the port."""

from kmunet_tpu_torch.models.ef import ConvLSTM_EF, TrajGRU_EF
from kmunet_tpu_torch.models.km_unet import KM_UNetV3, KM_UNetV3_LAPS, KM_UNetV3_SH
from kmunet_tpu_torch.models.lptqpn import LPTQPN
from kmunet_tpu_torch.models.mamba_unet import Mamba_UNet
from kmunet_tpu_torch.models.sceca_net import SCECANet
from kmunet_tpu_torch.models.smaat_unet import SmaAt_UNet
from kmunet_tpu_torch.models.swin_unet import SwinUNet
from kmunet_tpu_torch.models.transunet import TransUNet

__all__ = ["ConvLSTM_EF", "KM_UNetV3", "KM_UNetV3_LAPS", "KM_UNetV3_SH", "LPTQPN", "Mamba_UNet",
           "SCECANet", "SmaAt_UNet", "SwinUNet", "TrajGRU_EF", "TransUNet"]
