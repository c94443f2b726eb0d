"""Entry point: build the KM_UNetV3-SH forecaster and predict.

    model = build_km_unet_v3_sh()               # on "cuda"; raises without a card
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 20)

Pass ``device="cpu"`` to run on the CPU (the gather then takes its plain
version); nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH, init_weights_


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises if a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def build_km_unet_v3_sh(device=None, dtype: torch.dtype = torch.float32,
                        seed: int = 0) -> torch.nn.Module:
    """KM_UNetV3-SH (20 output frames, embed_dims 16/32/64) in eval mode,
    initialised from ``seed`` with the JAX package's distributions, on
    ``device`` in ``dtype``."""
    device = resolve_device(device)
    model = KM_UNetV3_SH()
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


@torch.inference_mode()
def predict(model: torch.nn.Module, frames) -> torch.Tensor:
    """Forecast maps (B, H, W, num_classes) in [0, 1] from input frames
    (B, H, W, 5), a tensor or array, moved to the model's device and dtype."""
    p = next(model.parameters())
    frames = torch.as_tensor(frames).to(device=p.device, dtype=p.dtype)
    return model(frames)
