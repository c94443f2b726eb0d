"""Model zoo registry (port of ``kmunet_tpu/models/zoo.py``): config names
to constructors, for the models the port has.

The port has KM_UNetV3 in its SH variant and the two encoder-forecaster
RNNs (``convlstm``, ``trajgru``). The others raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.models import ef, km_unet

# Which models take (B, S, H, W) sequences and return (B, T, H, W), and
# which take (B, H, W, C) frame stacks and return (B, H, W, T).
SEQUENCE_MODELS = {"convlstm", "trajgru"}


def build(model_cfg, dysample_window: bool = True) -> nn.Module:
    """The model of ``model_cfg`` (``configs.ModelConfig``) for
    ``num_classes`` output frames; ``dysample_window`` picks KM_UNetV3's
    DySample path (the JAX package's ``DYSAMPLE_WINDOW``, which its config
    does not carry either)."""
    name, n = model_cfg.name, model_cfg.num_classes
    extra = dict(model_cfg.extra)
    if name == "km_unet_v3":
        if model_cfg.variant != "sh":
            raise NotImplementedError(f"km_unet_v3 variant {model_cfg.variant!r}: not in the "
                                      "port yet; the LAPS variant is ROADMAP Queue 1 item 3")
        drop_path = float(extra.pop("drop_path", 0.1))
        if extra:
            raise NotImplementedError(f"model.extra {sorted(extra)}: not in the port yet; "
                                      "head_norm is ROADMAP Queue 1 item 3")
        return km_unet.KM_UNetV3(num_classes=n, embed_dims=tuple(model_cfg.embed_dims),
                                 drop_path=drop_path, dysample_window=dysample_window)
    if name in SEQUENCE_MODELS:
        if extra:
            raise ValueError(f"{name} takes no model.extra, got {sorted(extra)}")
        return (ef.ConvLSTM_EF if name == "convlstm" else ef.TrajGRU_EF)(out_frames=n)
    raise NotImplementedError(f"model {name!r}: not in the port yet (the zoo is ROADMAP "
                              "Queue 1 item 10)")


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of a zoo model with the JAX package's
    distributions."""
    if isinstance(model, ef._EF):
        return ef.init_weights_(model, generator)
    return km_unet.init_weights_(model, generator)
