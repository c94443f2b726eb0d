"""Experiment configs of the port (its own copy of ``kmunet_tpu/configs``)."""

from kmunet_tpu_torch.configs.base import (
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    laps_km_unet,
    parse_overrides,
    shanghai_km_unet,
)

__all__ = ["DataConfig", "ExperimentConfig", "MeshConfig", "ModelConfig", "TrainConfig",
           "laps_km_unet", "parse_overrides", "shanghai_km_unet"]
