"""The fields of ``kmunet_tpu/configs/base.py`` that the port's training
steps read, with the same names and defaults, written out again (the port
imports nothing of the JAX package).

``shanghai_km_unet()`` is the reference recipe (train_shanghai.py): AdamW lr
1e-3, weight decay 0.05 on every parameter, cosine T_max 200 and eta_min
5e-4 stepped per epoch, HybridLoss alpha 0.7, 5 -> 20 frames.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class DataConfig:
    """The shape of a batch: (batch_size, seq_len, img_size, img_size)."""

    img_size: int = 256
    seq_len: int = 25
    in_frames: int = 5
    out_frames: int = 20
    batch_size: int = 2
    thresholds: Sequence[float] = (20, 30, 35, 40)  # weighted_mse_mae's bands


@dataclasses.dataclass
class ModelConfig:
    name: str = "km_unet_v3"
    variant: str = "sh"               # sh | laps
    embed_dims: Sequence[int] = (16, 32, 64)
    num_classes: int = 20
    extra: dict = dataclasses.field(default_factory=dict)  # e.g. {"drop_path": 0.0}


@dataclasses.dataclass
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 1e-3
    weight_decay: float = 0.05
    momentum: float = 0.9             # sgd only
    schedule: str = "cosine_epoch"    # CosineAnnealingLR stepped per epoch
    cosine_t_max: int = 200
    eta_min: float = 5e-4
    milestones: Sequence[int] = (15000, 30000)  # MultiStepLR, epoch units
    gamma: float = 0.1                # MultiStepLR decay factor
    loss: str = "hybrid"
    loss_alpha: float = 0.7
    kan_reg_weight: float = 0.0       # 0 = off
    grad_clip: float = 0.0            # global-norm clip; 0 = off
    wd_mask_norms: bool = False       # False: decay every parameter, as the reference
    compute_dtype: str = "float32"    # float32 | bfloat16 (the AMP analogue)
    remat: bool = False


@dataclasses.dataclass
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def shanghai_km_unet() -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(out_frames=20, batch_size=2),
        model=ModelConfig(variant="sh", num_classes=20),
        train=TrainConfig(),
    )
