"""Entry point: build a forecaster and predict.

    model = build_km_unet_v3_sh()               # on "cuda"; raises without a card
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 20)

    model = build_zoo_model("trajgru")          # or "convlstm"
    forecast = predict(model, frames)           # (B, 5, H, W) -> (B, 20, H, W)

    model = build_zoo_model("mamba_unet")       # or "km_unet_v3"
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 20)

Pass ``device="cpu"`` to run on the CPU (the gathers then take their plain
versions); nothing falls back to the CPU on its own. Pass
``dysample_window=False`` for DySample's exact path (the K4 grouped gather),
``kan_fused=True`` for the KAN convs through K1 and ``ssd_mixer="fused"``
(or ``"compress"``) for the HSM-SSD mixers through K3 (or K2).
TrajGRU's warp is the K7 multiview gather, Mamba-UNet's scan K8.
"""

from __future__ import annotations

import torch

from kmunet_tpu_torch.configs import ModelConfig
from kmunet_tpu_torch.models import zoo
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH, init_weights_


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises if a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def build_km_unet_v3_sh(device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                        dysample_window: bool = True, kan_fused: bool = False,
                        ssd_mixer: str = "einsum") -> torch.nn.Module:
    """KM_UNetV3-SH (20 output frames, embed_dims 16/32/64) in eval mode,
    initialised from ``seed`` with the JAX package's distributions, on
    ``device`` in ``dtype``; ``dysample_window``, ``kan_fused`` and
    ``ssd_mixer`` as in ``KM_UNetV3``."""
    device = resolve_device(device)
    model = KM_UNetV3_SH(dysample_window=dysample_window, kan_fused=kan_fused,
                         ssd_mixer=ssd_mixer)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


def build_zoo_model(name: str, device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                    out_frames: int = 20) -> torch.nn.Module:
    """The zoo's model ``name`` (``km_unet_v3`` for the SH variant,
    ``convlstm``, ``trajgru``, ``mamba_unet``) forecasting ``out_frames`` frames, in eval
    mode, initialised from ``seed`` with the JAX package's distributions, on
    ``device`` in ``dtype``."""
    device = resolve_device(device)
    model = zoo.build(ModelConfig(name=name, num_classes=out_frames))
    zoo.init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


@torch.inference_mode()
def predict(model: torch.nn.Module, frames) -> torch.Tensor:
    """Forecast from input frames, a tensor or array, moved to the model's
    device and dtype: KM_UNetV3 maps (B, H, W, 5) to maps (B, H, W, T) in
    [0, 1], Mamba-UNet (B, H, W, 5) to (B, H, W, T), a sequence model
    (``zoo.SEQUENCE_MODELS``) (B, 5, H, W) to (B, T, H, W)."""
    p = next(model.parameters())
    frames = torch.as_tensor(frames).to(device=p.device, dtype=p.dtype)
    return model(frames)
