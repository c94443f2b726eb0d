"""The fields of ``kmunet_tpu/configs/base.py`` that the port's training
steps read, with the same names and defaults, written out again (the port
imports nothing of the JAX package).

``shanghai_km_unet()`` is the reference recipe (train_shanghai.py): AdamW lr
1e-3, weight decay 0.05 on every parameter, cosine T_max 200 and eta_min
5e-4 stepped per epoch, HybridLoss alpha 0.7, 5 -> 20 frames.
``laps_km_unet()`` is the LAPS one (train_LAPS.py): the LAPS variant, 5 -> 3
frames, batch 1, values not rescaled, thresholds on normalized values, the
same optimizer and loss.

``DataConfig.value_scale`` and ``TrainConfig.scatter_eval`` are carried for
parity with the JAX package's recipes only: the JAX package reads them in
its evaluation (``metrics/evaluator.py``, ``metrics/scatter_eval.py``),
which the port does not have yet, so nothing in the port reads them and
they change no training step. The port's evaluation, when it comes, reads
``value_scale`` and refuses ``scatter_eval=True`` until it implements the
scatter metrics.
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
    value_scale: float = 90.0         # raw value = normalized * value_scale (evaluation only)
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
    scatter_eval: bool = False        # LAPS's flattened per-threshold metrics (evaluation only)


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


def laps_km_unet() -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(seq_len=8, out_frames=3, batch_size=1, value_scale=1.0,
                        thresholds=(0.1, 0.3, 0.5, 0.7, 0.8)),
        model=ModelConfig(variant="laps", num_classes=3),
        train=TrainConfig(scatter_eval=True),
    )
