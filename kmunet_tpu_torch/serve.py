"""Entry point: build a forecaster and predict.

    model = build_km_unet_v3_sh()               # on "cuda"; raises without a card
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 20)

    model = build_km_unet_v3_laps()             # the LAPS variant
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 3)

    model = build_zoo_model("trajgru")          # or "convlstm"
    forecast = predict(model, frames)           # (B, 5, H, W) -> (B, 20, H, W)

    model = build_zoo_model("mamba_unet")       # or "km_unet_v3", or a baseline:
    forecast = predict(model, frames)           # (B, H, W, 5) -> (B, H, W, 20)
    # "smaat_unet", "sceca_net", "lptqpn", "transunet", "swin_unet" (256^2 by
    # default: img_size sizes TransUNet and Swin-UNet)

    model = build_efficient_vim("m1")           # the classifier, "m1" to "m4"
    logits = classify(model, images)            # (B, 224, 224, 3) -> (B, 1000)

Pass ``device="cpu"`` to run on the CPU (the gathers then take their plain
versions); nothing falls back to the CPU on its own. Pass
``dysample_window=False`` for DySample's exact path (the K4 grouped gather),
``kan_fused=True`` for the KAN convs through K1 and ``ssd_mixer="fused"``
(or ``"compress"``) for the HSM-SSD mixers through K3 (or K2), on either
variant (and on the classifier: its 6 or 9 mixers); ``head_norm=False``
for a head without its GroupNorm. TrajGRU's warp is the K7 multiview
gather, Mamba-UNet's scan K8.
"""

from __future__ import annotations

import torch

from kmunet_tpu_torch.configs import ModelConfig
from kmunet_tpu_torch.models import efficient_vim, zoo
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_LAPS, KM_UNetV3_SH, init_weights_


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises if a CUDA device is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def _ready(model, device, dtype, seed) -> torch.nn.Module:
    """``model`` initialised from ``seed`` with the JAX package's
    distributions, on ``device`` in ``dtype``, in eval mode."""
    device = resolve_device(device)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


def build_km_unet_v3_sh(device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                        dysample_window: bool = True, kan_fused: bool = False,
                        ssd_mixer: str = "einsum", head_norm: bool = True) -> torch.nn.Module:
    """KM_UNetV3-SH (20 output frames, embed_dims 16/32/64) in eval mode,
    initialised from ``seed`` with the JAX package's distributions, on
    ``device`` in ``dtype``; ``dysample_window``, ``kan_fused``,
    ``ssd_mixer`` and ``head_norm`` as in ``KM_UNetV3``."""
    return _ready(KM_UNetV3_SH(dysample_window=dysample_window, kan_fused=kan_fused,
                               ssd_mixer=ssd_mixer, head_norm=head_norm), device, dtype, seed)


def build_km_unet_v3_laps(device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                          head_norm: bool = True, kan_fused: bool = False,
                          ssd_mixer: str = "einsum") -> torch.nn.Module:
    """KM_UNetV3-LAPS (3 output frames, embed_dims 16/32/64; no bridge,
    align-corners bilinear upsampling) in eval mode, initialised from
    ``seed`` with the JAX package's distributions, on ``device`` in
    ``dtype``; ``head_norm``, ``kan_fused`` and ``ssd_mixer`` as in
    ``KM_UNetV3``."""
    return _ready(KM_UNetV3_LAPS(head_norm=head_norm, kan_fused=kan_fused, ssd_mixer=ssd_mixer),
                  device, dtype, seed)


def build_zoo_model(name: str, device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                    out_frames: int = 20, img_size: int = 256) -> torch.nn.Module:
    """The zoo's model ``name`` (``km_unet_v3`` for the SH variant,
    ``convlstm``, ``trajgru``, ``mamba_unet``, ``smaat_unet``,
    ``sceca_net``, ``lptqpn``, ``transunet``, ``swin_unet``) forecasting
    ``out_frames`` frames, in eval mode, initialised from ``seed`` with the
    JAX package's distributions, on ``device`` in ``dtype``. TransUNet and
    Swin-UNet take inputs of ``img_size`` squared only."""
    device = resolve_device(device)
    model = zoo.build(ModelConfig(name=name, num_classes=out_frames), img_size=img_size)
    zoo.init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).eval()


@torch.inference_mode()
def predict(model: torch.nn.Module, frames) -> torch.Tensor:
    """Forecast from input frames, a tensor or array, moved to the model's
    device and dtype: KM_UNetV3 maps (B, H, W, 5) to maps (B, H, W, T) in
    [0, 1], Mamba-UNet and the baselines (B, H, W, 5) to (B, H, W, T), a sequence model
    (``zoo.SEQUENCE_MODELS``) (B, 5, H, W) to (B, T, H, W)."""
    p = next(model.parameters())
    frames = torch.as_tensor(frames).to(device=p.device, dtype=p.dtype)
    return model(frames)


def build_efficient_vim(variant: str = "m1", device=None, dtype: torch.dtype = torch.float32,
                        seed: int = 0, num_classes: int = 1000, ssd_mixer: str = "einsum",
                        distillation: bool = False) -> torch.nn.Module:
    """The EfficientViM classifier ``variant`` ("m1" to "m4") for
    ``num_classes`` classes in eval mode, initialised from ``seed`` with
    the JAX package's distributions, on ``device`` in ``dtype``;
    ``ssd_mixer`` and ``distillation`` as in ``EfficientViM``."""
    if variant not in efficient_vim.VARIANTS:
        raise ValueError(f"variant must be one of {sorted(efficient_vim.VARIANTS)}, "
                         f"got {variant!r}")
    model = efficient_vim.VARIANTS[variant](num_classes=num_classes, ssd_mixer=ssd_mixer,
                                            distillation=distillation)
    return _ready(model, device, dtype, seed)


@torch.inference_mode()
def classify(model: torch.nn.Module, images) -> torch.Tensor:
    """Logits (B, num_classes) of images (B, H, W, 3), a tensor or array,
    moved to the model's device and dtype."""
    p = next(model.parameters())
    return model(torch.as_tensor(images).to(device=p.device, dtype=p.dtype))
