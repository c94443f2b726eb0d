"""Optimizers of the port (port of ``kmunet_tpu/train/optimizers.py``).

AdamW (the SH recipe's), Adam (the ConvLSTM and TrajGRU recipes') and SGD
with momentum (Mamba-UNet's "pic" recipe and most of the zoo's) are ported;
the other six of the reference's factory wait for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]
B1, B2, EPS = 0.9, 0.999, 1e-8  # the JAX factory's defaults; no recipe sets others


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far (optax's ``count``)
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class AdamW:
    """``optax.adamw`` on a list of fp32 tensors, updated in place.

    mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + (1 - b2) g^2;
    u = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p;
    p <- p - lr(t - 1) * u
    with t the count after the update: the bias corrections are computed in
    fp32 as optax computes them, eps lies outside the square root, the decay
    is decoupled (``lr * wd * p``) and applies to every tensor, and the
    schedule is read at the count *before* the update. The moments and the
    parameters are updated in place (the JAX step donates its state) with
    PyTorch's multi-tensor ``_foreach`` ops, a few launches for all tensors.

    ``torch.optim.AdamW`` computes the same update in another order (the
    decay first, as ``p * (1 - lr * wd)``, and the bias corrections in
    float64): three steps on optax's inputs land up to 2 fp32 ulps away
    from optax, where this order agrees within 1e-7.
    """

    def __init__(self, learning_rate: Schedule, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params],
                          [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamWState,
               params: list[torch.Tensor]) -> AdamWState:
        """Applies one update to ``params`` in place; returns the new state."""
        lr = self.lr(state.count)
        t = state.count + 1
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        bc1 = float(1 - np.float32(B1) ** t)
        bc2 = float(1 - np.float32(B2) ** t)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        return AdamWState(t, mu, nu)


class Adam(AdamW):
    """``optax.adam``: the AdamW update with no decoupled decay. A nonzero
    ``weight_decay`` is torch Adam's coupled L2 decay, as the JAX factory
    chains it (``optax.add_decayed_weights`` before ``optax.adam``): ``wd * p``
    is added to the gradient before the moments see it."""

    def __init__(self, learning_rate: Schedule, weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay=0.0)
        self.l2 = weight_decay

    def update(self, grads: list[torch.Tensor], state: AdamWState,
               params: list[torch.Tensor]) -> AdamWState:
        if self.l2:
            grads = torch._foreach_add(grads, params, alpha=self.l2)
        return super().update(grads, state, params)


class SGD(AdamW):
    """``optax.sgd(lr, momentum)``: trace <- g + momentum * trace, from a
    zero trace (so the first update is -lr * g), and p <- p - lr * trace,
    the schedule read at the count before the update; momentum 0 is plain
    SGD (the JAX factory's ``momentum or None``) and keeps no trace. A
    nonzero ``weight_decay`` is coupled into the gradient, as the JAX
    factory chains ``optax.add_decayed_weights`` before it. The state is
    AdamW's, with the trace in ``mu`` and ``nu`` empty."""

    def __init__(self, learning_rate: Schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay=0.0)
        self.momentum = momentum
        self.l2 = weight_decay

    def init(self, params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p) for p in params] if self.momentum else [], [])

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamWState,
               params: list[torch.Tensor]) -> AdamWState:
        """Applies one update to ``params`` in place; returns the new state."""
        lr = self.lr(state.count)
        if self.l2:
            grads = torch._foreach_add(grads, params, alpha=self.l2)
        trace = state.mu
        if self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, torch._foreach_mul(trace if self.momentum else grads, -lr))
        return AdamWState(state.count + 1, trace, state.nu)


def make_optimizer(name: str, learning_rate: Schedule, *, weight_decay: float = 0.0,
                   momentum: float = 0.9) -> AdamW:
    """The optimizer factory; the port has ``adamw``, ``adam`` and ``sgd``
    (``momentum`` is SGD's)."""
    name = name.lower()
    if name == "adamw":
        return AdamW(learning_rate, weight_decay=weight_decay)
    if name == "adam":
        return Adam(learning_rate, weight_decay=weight_decay)
    if name == "sgd":
        return SGD(learning_rate, momentum=momentum, weight_decay=weight_decay)
    raise NotImplementedError(
        f"optimizer {name!r}: the port has adamw, adam and sgd only (ROADMAP Queue 1 item 5)")
