"""Model zoo registry (port of ``kmunet_tpu/models/zoo.py``): config names
to constructors.

KM_UNetV3 in its SH and LAPS variants, the two encoder-forecaster RNNs
(``convlstm``, ``trajgru``), Mamba-UNet (``mamba_unet``) and the five
baselines ``smaat_unet``, ``sceca_net``, ``lptqpn``, ``transunet`` and
``swin_unet``, each with the JAX constructor's arguments from
``model.extra``. An unknown name raises ``ValueError``, as JAX's zoo does.
"""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.models import (ef, km_unet, lptqpn, mamba_unet, sceca_net, smaat_unet,
                                     swin_unet, transunet)

# Which models take (B, S, H, W) sequences and return (B, T, H, W), and
# which take (B, H, W, C) frame stacks and return (B, H, W, T).
SEQUENCE_MODELS = {"convlstm", "trajgru"}
# The models whose forward in training takes the ``torch.Generator`` that
# their stochastic depth or dropout draws from.
STOCHASTIC_MODELS = {"km_unet_v3", "sceca_net", "transunet", "swin_unet"}
# The baselines: name -> (constructor, its output-count argument, whether it
# takes the input size, which fixes TransUNet's and Swin-UNet's shapes).
_BASELINES = {
    "smaat_unet": (smaat_unet.SmaAt_UNet, "n_classes", False),
    "sceca_net": (sceca_net.SCECANet, "out_channels", False),
    "lptqpn": (lptqpn.LPTQPN, "out_frames", False),
    "transunet": (transunet.TransUNet, "num_classes", True),
    "swin_unet": (swin_unet.SwinUNet, "num_classes", True),
}


def build(model_cfg, dysample_window: bool = True, kan_fused: bool = False,
          ssd_mixer: str = "einsum", img_size: int = 256, in_frames: int = 5) -> nn.Module:
    """The model of ``model_cfg`` (``configs.ModelConfig``) for
    ``num_classes`` output frames; KM_UNetV3 in ``model_cfg.variant`` with
    ``model_cfg.extra``'s ``drop_path`` and ``head_norm``, the others with
    their constructors' arguments from ``model_cfg.extra``.
    ``dysample_window`` picks KM_UNetV3's DySample path (the JAX package's
    ``DYSAMPLE_WINDOW``, which its config does not carry either),
    ``kan_fused`` and ``ssd_mixer`` its KAN convs' and HSM-SSD mixers'
    (``KM_UNetV3``); another model given either raises. ``img_size`` is
    the input's height and width, which TransUNet's position embeddings and
    Swin-UNet's windows are sized from (flax sizes them at init), and
    ``in_frames`` the frames a stack model takes as input channels (flax
    infers them from the init's dummy of ``cfg.data.in_frames`` frames; the
    sequence models take the sequence as it comes)."""
    name, n = model_cfg.name, model_cfg.num_classes
    extra = dict(model_cfg.extra)
    if name != "km_unet_v3" and (kan_fused or ssd_mixer != "einsum"):
        raise ValueError(f"{name} has no KAN conv or HSM-SSD mixer: kan_fused and ssd_mixer "
                         "are KM_UNetV3's")
    if name == "km_unet_v3":
        drop_path = float(extra.pop("drop_path", 0.1))
        head_norm = bool(extra.pop("head_norm", True))
        if extra:
            raise ValueError(f"km_unet_v3 takes model.extra drop_path and head_norm, "
                             f"got {sorted(extra)}")
        return km_unet.KM_UNetV3(num_classes=n, embed_dims=tuple(model_cfg.embed_dims),
                                 drop_path=drop_path, dysample_window=dysample_window,
                                 kan_fused=kan_fused, ssd_mixer=ssd_mixer,
                                 variant=model_cfg.variant, head_norm=head_norm,
                                 in_frames=in_frames)
    if name in SEQUENCE_MODELS:
        if extra:
            raise ValueError(f"{name} takes no model.extra, got {sorted(extra)}")
        return (ef.ConvLSTM_EF if name == "convlstm" else ef.TrajGRU_EF)(out_frames=n)
    if name == "mamba_unet":
        unknown = set(extra) - {"c_list", "bridge", "seq_mesh"}
        if unknown:
            raise ValueError(f"mamba_unet takes model.extra c_list, bridge and seq_mesh, "
                             f"got {sorted(unknown)}")
        return mamba_unet.Mamba_UNet(predicted_frames=n, input_frames=in_frames, **extra)
    if name in _BASELINES:
        cls, out_arg, sized = _BASELINES[name]
        if sized:
            extra["img_size"] = img_size
        return cls(**{out_arg: n}, in_channels=in_frames, **extra)
    raise ValueError(f"unknown model {name!r}")


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of a zoo model with the JAX package's
    distributions."""
    if isinstance(model, ef._EF):
        return ef.init_weights_(model, generator)
    if isinstance(model, mamba_unet.Mamba_UNet):
        return mamba_unet.init_weights_(model, generator)
    # KM_UNetV3 and the baselines: every conv and linear kaiming-uniform with
    # a zero bias, then each module's own rule (``init_weights_``).
    return km_unet.init_weights_(model, generator)
