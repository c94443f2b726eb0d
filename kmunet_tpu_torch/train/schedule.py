"""LR schedules (port of ``kmunet_tpu/train/schedule.py``).

The reference steps ``CosineAnnealingLR(T_max=200, eta_min=5e-4)`` once per
epoch, so the schedule is a function of ``step // steps_per_epoch``.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_per_epoch(base_lr: float, eta_min: float, t_max: int,
                               steps_per_epoch: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        cos = (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0
        return eta_min + (base_lr - eta_min) * cos

    return schedule
