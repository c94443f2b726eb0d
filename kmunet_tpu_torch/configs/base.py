"""The port's copy of ``kmunet_tpu/configs/base.py``: the same dataclasses,
fields, defaults and recipes, and the same dotted-path command-line
overrides (``--train.lr=3e-4 --data.img_size=128``), written out again (the
port imports nothing of the JAX package).

``shanghai_km_unet()`` is the reference recipe (train_shanghai.py): AdamW lr
1e-3, weight decay 0.05 on every parameter, cosine T_max 200 and eta_min
5e-4 stepped per epoch, HybridLoss alpha 0.7, 5 -> 20 frames at 256^2,
batch 2, the Shanghai radar data. ``laps_km_unet()`` is the LAPS one
(train_LAPS.py): the LAPS variant, 5 -> 3 frames, batch 1, values not
rescaled, thresholds on normalized values, the same optimizer and loss, and
the flattened scatter metrics in the test pass.

``MeshConfig`` is the JAX one: the trainer runs one process per card over
that mesh (``parallel.make_mesh``; data parallelism, FSDP on 'model', and
the image rows of KM_UNetV3, ConvLSTM, TrajGRU and Mamba-UNet sharded on
'spatial'); ``train/engine.py`` refuses ``spatial`` > 1 for the five
baselines, through K1-K3 and for rows that do not divide evenly (ROADMAP
Queue 1 item 12).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class DataConfig:
    """The data and the shape of a batch: (batch_size, seq_len, img_size, img_size)."""

    name: str = "synthetic"           # synthetic | shanghai | laps
    path: Optional[str] = None        # the HDF5 file of shanghai and laps
    img_size: int = 256
    seq_len: int = 25
    in_frames: int = 5
    out_frames: int = 20
    batch_size: int = 2
    num_workers: int = 4              # the loader's worker threads
    value_scale: float = 90.0         # raw value = normalized * value_scale (evaluation)
    thresholds: Sequence[float] = (20, 30, 35, 40)  # the evaluation's and weighted_mse_mae's
    synthetic_length: int = 64
    device_cache: bool = False        # keep the train and val corpora on the device and
                                      # gather each batch there (no per-step host copy)
    lpips_weights: Optional[str] = None  # .npz of metrics/lpips.py's converter; without it
                                         # LPIPS reports "needs weights"


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
    momentum: float = 0.9             # sgd/rmsprop only
    schedule: str = "cosine_epoch"    # CosineAnnealingLR stepped per epoch
    cosine_t_max: int = 200
    eta_min: float = 5e-4
    milestones: Sequence[int] = (15000, 30000)  # MultiStepLR, epoch units
    gamma: float = 0.1                # MultiStepLR/StepLR decay factor
    plateau_factor: float = 0.1       # schedule="plateau" (ReduceLROnPlateau)
    plateau_patience: int = 10        # epochs without val improvement
    epochs: int = 120
    loss: str = "hybrid"
    loss_alpha: float = 0.7
    kan_reg_weight: float = 0.0       # 0 = off
    grad_clip: float = 0.0            # global-norm clip; 0 = off
    wd_mask_norms: bool = False       # False: decay every parameter, as the reference
    nan_abort: bool = True            # stop the epoch loop at a non-finite train/val loss
    seed: int = 42
    log_every: int = 50
    ckpt_dir: Optional[str] = None
    compute_dtype: str = "float32"    # float32 | bfloat16 (the AMP analogue)
    resume: bool = False              # restore the latest checkpoint of ckpt_dir
    early_stop_patience: int = 0      # 0 = off; epochs without val improvement
    remat: bool = False
    out_dir: Optional[str] = None     # results.json, PNG strips and the scatter CSV
    vis_batches: int = 10             # test batches dumped as PNG strips (needs out_dir)
    scatter_eval: bool = False        # LAPS's flattened per-threshold metrics


@dataclasses.dataclass
class MeshConfig:
    data: int = -1
    spatial: int = 1
    model: int = 1
    fsdp: bool = False


@dataclasses.dataclass
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def shanghai_km_unet() -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(name="shanghai", out_frames=20, batch_size=2),
        model=ModelConfig(variant="sh", num_classes=20),
        train=TrainConfig(),
    )


def laps_km_unet() -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(name="laps", seq_len=8, out_frames=3, batch_size=1, value_scale=1.0,
                        thresholds=(0.1, 0.3, 0.5, 0.7, 0.8)),
        model=ModelConfig(variant="laps", num_classes=3),
        train=TrainConfig(scatter_eval=True),
    )


def _set_dotted(cfg, dotted: str, raw: str):
    """Sets the field at ``dotted`` from the string ``raw``, typed as the
    field's current value: a bool from 1/true/yes, an int, a float, a
    comma-separated tuple or list of the first element's type (float when
    empty), else the string. A dict leaf (``--model.extra.drop_path=0.0``)
    has no value to take a type from: lowercase true/false become bools
    (else the truthy string 'false'), anything else a Python literal, or the
    string when it is none."""
    obj = cfg
    *path, leaf = dotted.split(".")
    for p in path:
        obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
    if isinstance(obj, dict):
        if raw.lower() in ("true", "false"):
            obj[leaf] = raw.lower() == "true"
            return
        try:
            obj[leaf] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            obj[leaf] = raw
        return
    current = getattr(obj, leaf)
    if isinstance(current, bool):
        value = raw.lower() in ("1", "true", "yes")
    elif isinstance(current, int):
        value = int(raw)
    elif isinstance(current, float):
        value = float(raw)
    elif isinstance(current, (tuple, list)):
        value = type(current)(type(current[0])(v) if current else float(v) for v in raw.split(","))
    else:
        value = raw
    setattr(obj, leaf, value)


def parse_overrides(cfg: ExperimentConfig, argv: Sequence[str]) -> ExperimentConfig:
    """Apply ``--a.b=value`` style overrides in place; returns cfg."""
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"unrecognized argument {arg!r} (expected --path=value)")
        body = arg[2:]
        if "=" not in body:
            raise ValueError(f"override {arg!r} must be --path=value")
        dotted, raw = body.split("=", 1)
        _set_dotted(cfg, dotted, raw)
    return cfg
