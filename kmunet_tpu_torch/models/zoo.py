"""Model zoo registry (port of ``kmunet_tpu/models/zoo.py``): config names
to constructors, for the models the port has.

The port has KM_UNetV3 in its SH and LAPS variants, the two encoder-forecaster RNNs
(``convlstm``, ``trajgru``) and Mamba-UNet (``mamba_unet``). The others
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch
from torch import nn

from kmunet_tpu_torch.models import ef, km_unet, mamba_unet

# Which models take (B, S, H, W) sequences and return (B, T, H, W), and
# which take (B, H, W, C) frame stacks and return (B, H, W, T).
SEQUENCE_MODELS = {"convlstm", "trajgru"}


def build(model_cfg, dysample_window: bool = True, kan_fused: bool = False,
          ssd_mixer: str = "einsum") -> nn.Module:
    """The model of ``model_cfg`` (``configs.ModelConfig``) for
    ``num_classes`` output frames; KM_UNetV3 in ``model_cfg.variant`` with
    ``model_cfg.extra``'s ``drop_path`` and ``head_norm``. ``dysample_window``
    picks KM_UNetV3's DySample path (the JAX package's ``DYSAMPLE_WINDOW``,
    which its config does not carry either), ``kan_fused`` and ``ssd_mixer``
    its KAN convs' and HSM-SSD mixers' (``KM_UNetV3``); another model given
    either raises."""
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
                                 variant=model_cfg.variant, head_norm=head_norm)
    if name in SEQUENCE_MODELS:
        if extra:
            raise ValueError(f"{name} takes no model.extra, got {sorted(extra)}")
        return (ef.ConvLSTM_EF if name == "convlstm" else ef.TrajGRU_EF)(out_frames=n)
    if name == "mamba_unet":
        if "seq_mesh" in extra:
            raise NotImplementedError("mamba_unet seq_mesh: the sequence-parallel scan needs a "
                                      "device mesh, not in the port yet (ROADMAP Queue 1 item 9)")
        unknown = set(extra) - {"c_list", "bridge"}
        if unknown:
            raise ValueError(f"mamba_unet takes model.extra c_list and bridge, "
                             f"got {sorted(unknown)}")
        return mamba_unet.Mamba_UNet(predicted_frames=n, **extra)
    raise NotImplementedError(f"model {name!r}: not in the port yet (the zoo is ROADMAP "
                              "Queue 1 item 10)")


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation of a zoo model with the JAX package's
    distributions."""
    if isinstance(model, ef._EF):
        return ef.init_weights_(model, generator)
    if isinstance(model, mamba_unet.Mamba_UNet):
        return mamba_unet.init_weights_(model, generator)
    return km_unet.init_weights_(model, generator)
