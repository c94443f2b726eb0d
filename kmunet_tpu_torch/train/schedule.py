"""LR schedules (port of ``kmunet_tpu/train/schedule.py`` and of
``make_schedule`` in ``kmunet_tpu/train/optimizers.py``).

The reference steps its schedulers once per epoch, so each schedule is a
function of ``step // steps_per_epoch``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def cosine_annealing_per_epoch(base_lr: float, eta_min: float, t_max: int,
                               steps_per_epoch: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        cos = (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0
        return eta_min + (base_lr - eta_min) * cos

    return schedule


def make_schedule(name: str, base_lr: float, steps_per_epoch: int, *,
                  milestones: Sequence[int] = (30, 60), gamma: float = 0.1,
                  t_max: int = 200, eta_min: float = 0.0) -> Callable[[int], float]:
    """``lr(step)`` of the schedule ``name``; the port has ``MultiStepLR``,
    ``base_lr * gamma ** (the number of milestones <= step // steps_per_epoch)``,
    and ``CosineAnnealingLR``, ``cosine_annealing_per_epoch`` with ``eta_min``
    and ``t_max``. The other names of the JAX factory raise
    ``NotImplementedError``."""
    if name == "CosineAnnealingLR":
        return cosine_annealing_per_epoch(base_lr, eta_min, t_max, steps_per_epoch)
    if name != "MultiStepLR":
        raise NotImplementedError(f"schedule {name!r}: the port has cosine_epoch, "
                                  "CosineAnnealingLR and MultiStepLR only (ROADMAP Queue 1 "
                                  "item 5)")
    spe = max(steps_per_epoch, 1)
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        epoch = step // spe
        return base_lr * gamma ** sum(m <= epoch for m in ms)

    return schedule
