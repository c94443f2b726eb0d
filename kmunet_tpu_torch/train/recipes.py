"""Per-model training recipes of the baseline zoo (the data of
``kmunet_tpu/train/recipes.py``, written out again): optimizer, lr, loss,
schedule and epochs of each reference training script, keyed by (model,
recipe), "nc" (LAPS, 5-in/3-out) or "pic" (Shanghai, 5-in/20-out).

Every reference script steps its scheduler once per epoch, so the
MultiStepLR milestones [15000, 30000] never fire within <= 150 epochs;
they are kept as written (epoch units). The bare ``torch.optim.AdamW``
calls inherit torch's default weight decay 1e-2; the bare ``Adam`` calls
its 0. The port's engine runs every optimizer, schedule and loss the
table names.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from kmunet_tpu_torch.configs.base import ExperimentConfig


@dataclasses.dataclass(frozen=True)
class Recipe:
    optimizer: str
    lr: float
    loss: str
    schedule: str                      # a name of train/optimizers.py::make_schedule
    epochs: int
    weight_decay: float = 0.0
    momentum: float = 0.0
    eta_min: float = 0.0
    t_max: int = 0
    milestones: Sequence[int] = ()
    gamma: float = 0.1


_MULTISTEP = dict(schedule="MultiStepLR", milestones=(15000, 30000), gamma=0.1)
_SGD = dict(optimizer="sgd", momentum=0.9, weight_decay=1e-4)

RECIPES: dict[tuple[str, str], Recipe] = {
    # ---- NC (LAPS) ----
    ("sceca_net", "nc"): Recipe(optimizer="adamw", lr=1e-3, loss="rain",
                                epochs=60, weight_decay=1e-2, **_MULTISTEP),
    ("smaat_unet", "nc"): Recipe(lr=1e-2, loss="rain", epochs=60,
                                 schedule="CosineAnnealingLR", t_max=30,
                                 eta_min=1e-4, **_SGD),
    ("lptqpn", "nc"): Recipe(optimizer="adamw", lr=1e-3, loss="rain",
                             epochs=60, weight_decay=1e-2,
                             schedule="CosineAnnealingLR",
                             t_max=30, eta_min=1e-9),
    ("mamba_unet", "nc"): Recipe(optimizer="adam", lr=1e-3, loss="rainfall",
                                 epochs=40, schedule="CosineAnnealingLR",
                                 t_max=50, eta_min=1e-5),
    ("swin_unet", "nc"): Recipe(lr=1e-2, loss="rain", epochs=60,
                                schedule="CosineAnnealingLR", t_max=30,
                                eta_min=5e-4, **_SGD),
    ("trajgru", "nc"): Recipe(optimizer="adam", lr=1e-4,
                              loss="weighted_mse_mae", epochs=60, **_MULTISTEP),
    ("transunet", "nc"): Recipe(lr=1e-2, loss="rain", epochs=60,
                                **_SGD, **_MULTISTEP),
    # ---- pic (Shanghai) ----
    ("sceca_net", "pic"): Recipe(lr=1e-3, loss="rain", epochs=60,
                                 **_SGD, **_MULTISTEP),
    ("smaat_unet", "pic"): Recipe(lr=1e-2, loss="rain", epochs=60,
                                  schedule="CosineAnnealingLR", t_max=30,
                                  eta_min=1e-9, **_SGD),
    ("convlstm", "pic"): Recipe(optimizer="adam", lr=1e-4,
                                loss="weighted_mse_mae", epochs=60, **_MULTISTEP),
    ("lptqpn", "pic"): Recipe(optimizer="adamw", lr=1e-3, loss="rain",
                              epochs=60, weight_decay=1e-2,
                              schedule="CosineAnnealingLR",
                              t_max=30, eta_min=1e-9),
    ("mamba_unet", "pic"): Recipe(lr=1e-3, loss="rainfall", epochs=60,
                                  schedule="CosineAnnealingLR", t_max=50,
                                  eta_min=1e-5, **_SGD),
    ("swin_unet", "pic"): Recipe(lr=1e-2, loss="rain", epochs=150,
                                 schedule="CosineAnnealingLR", t_max=150,
                                 eta_min=1e-3, **_SGD),
    ("trajgru", "pic"): Recipe(optimizer="adam", lr=1e-4,
                               loss="weighted_mse_mae", epochs=60, **_MULTISTEP),
    ("transunet", "pic"): Recipe(lr=1e-2, loss="rain", epochs=60,
                                 **_SGD, **_MULTISTEP),
}


def apply_recipe(cfg: ExperimentConfig, model: str, recipe: str) -> ExperimentConfig:
    """Overwrites ``cfg.train`` with the (model, recipe) settings and sets
    ``cfg.model.name``; the data config stays as it is (``shanghai_km_unet()``
    for "pic")."""
    key = (model, recipe)
    if key not in RECIPES:
        available = sorted(k for k in RECIPES if k[1] == recipe)
        raise KeyError(f"no reference recipe for {key}; audited: {available}")
    r = RECIPES[key]
    t = cfg.train
    t.optimizer = r.optimizer
    t.lr = r.lr
    t.weight_decay = r.weight_decay
    t.momentum = r.momentum
    t.loss = r.loss
    t.schedule = r.schedule
    t.epochs = r.epochs
    t.eta_min = r.eta_min
    if r.t_max:
        t.cosine_t_max = r.t_max
    t.milestones = tuple(r.milestones)
    t.gamma = r.gamma
    cfg.model.name = model
    return cfg
