"""LR schedules (port of ``kmunet_tpu/train/schedule.py`` and of
``make_schedule`` in ``kmunet_tpu/train/optimizers.py``).

The reference steps its schedulers once per epoch, so each schedule is a
function of ``step // steps_per_epoch``. The port evaluates them in float64
where JAX evaluates them in fp32, so learning rates lie up to an fp32 ulp
apart; the warm restarts' cycle is found with integer arithmetic, so every
epoch lands in the cycle JAX's puts it in.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union


def cosine_annealing_per_epoch(base_lr: float, eta_min: float, t_max: int,
                               steps_per_epoch: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        cos = (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0
        return eta_min + (base_lr - eta_min) * cos

    return schedule


def _restart_cycle(epoch: int, t_0: int, t_mult) -> tuple[int, float]:
    """(the first epoch, the length) of the warm-restart cycle holding
    ``epoch``: cycles of t_0, t_0 * t_mult, t_0 * t_mult^2, ... epochs.
    JAX finds the cycle's index as floor(log(e / t_0 (t_mult - 1) + 1) /
    log(t_mult)) in fp32, which float64 gets wrong at some restarts (at
    epoch 1210 for t_0 10, t_mult 3 it gives 4.999... where JAX's fp32 and
    the exact value give 5)."""
    if t_mult == 1:
        return epoch - epoch % t_0, t_0
    start, length = 0, t_0
    while start + length <= epoch:
        start, length = start + length, length * t_mult
    return start, length


def make_schedule(name: str, base_lr: float, steps_per_epoch: int, *,
                  step_size: int = 30, gamma: float = 0.1,
                  milestones: Sequence[int] = (30, 60), t_max: int = 200,
                  eta_min: float = 0.0, t_0: int = 10, t_mult: int = 2,
                  warm_up_epochs: int = 5,
                  epochs: int = 100) -> Union[float, Callable[[int], float]]:
    """``lr(step)`` of the schedule ``name`` (the reference's
    ``models/utils.py:154-214``, as the JAX factory names and defaults
    them); ``"constant"`` returns ``base_lr`` itself. An unknown name raises
    ``ValueError``, as in JAX."""
    spe = max(steps_per_epoch, 1)

    def per_epoch(f):
        return lambda step: base_lr * f(step // spe)

    ms = sorted(milestones)
    if name == "StepLR":
        return per_epoch(lambda e: gamma ** (e // step_size))
    if name == "MultiStepLR":
        return per_epoch(lambda e: gamma ** sum(m <= e for m in ms))
    if name == "ExponentialLR":
        return per_epoch(lambda e: gamma ** e)
    if name == "CosineAnnealingLR":
        return cosine_annealing_per_epoch(base_lr, eta_min, t_max, steps_per_epoch)
    if name == "CosineAnnealingWarmRestarts":
        def warm_restart(step: int) -> float:
            e = step // spe
            start, length = _restart_cycle(e, t_0, t_mult)
            cos = 1 + math.cos(math.pi * (e - start) / length)
            return eta_min + (base_lr - eta_min) * cos / 2
        return warm_restart
    if name == "WP_MultiStepLR":
        def wp_multistep(step: int) -> float:
            e = step // spe
            if e <= warm_up_epochs:
                return base_lr * (e / warm_up_epochs)
            return base_lr * gamma ** sum(m <= e for m in ms)
        return wp_multistep
    if name == "WP_CosineLR":
        def wp_cosine(step: int) -> float:
            e = step // spe
            if e <= warm_up_epochs:
                return base_lr * (e / warm_up_epochs)
            return base_lr * (0.5 * (math.cos((e - warm_up_epochs) / (epochs - warm_up_epochs)
                                              * math.pi) + 1))
        return wp_cosine
    if name == "constant":
        return base_lr
    raise ValueError(f"unsupported scheduler {name!r}")
