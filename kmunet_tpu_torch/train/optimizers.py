"""Optimizers of the port (port of ``kmunet_tpu/train/optimizers.py``) and
the stages that ``train/engine.py::build_optimizer`` chains around them.

Every optimizer of the JAX factory ``make_optimizer`` is here, each in
optax's arithmetic (optax 0.2.6) with the factory's defaults, on a list of
fp32 tensors updated in place (the JAX step donates its state) with
PyTorch's multi-tensor ``_foreach`` ops, a few launches for all tensors.
The factory's ``weight_decay`` is coupled into the gradient
(``optax.add_decayed_weights`` chained in front) for every optimizer but
AdamW, whose decay is decoupled, adadelta, which takes it inside in the
same place, and rprop, which ignores it. A schedule is read at the count
before the update. ``update``'s ``scale`` multiplies the final update:
the plateau's ``optax.scale`` stage at the end of build_optimizer's chain.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]
# The JAX factory's defaults, which no recipe changes: Adam's betas and eps
# (every optimizer's eps), RMSprop's decay (its alpha), Adadelta's rho,
# Adagrad's initial accumulator (optax's), and rprop's etas and step sizes.
B1, B2, EPS = 0.9, 0.999, 1e-8
RMSPROP_DECAY = 0.99
ADADELTA_RHO = 0.9
ADAGRAD_INITIAL = 0.1
RPROP_ETAS = (0.5, 1.2)
RPROP_STEP_SIZES = (1e-6, 50.0)


@dataclasses.dataclass
class OptState:
    """``count``: updates applied so far (optax's ``count``); ``mu``, ``nu``
    and ``trace``: per-parameter slots, as each optimizer names them."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    trace: list[torch.Tensor] = dataclasses.field(default_factory=list)


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _masked(tensors, mask):
    return [t for t, m in zip(tensors, mask) if m]


def norms_mask(params: list[torch.Tensor]) -> list[bool]:
    """``wd_mask_norms``'s mask: True for the tensors of 2 or more dims
    (conv and dense kernels), False for norm scales, biases and 0-d leaves."""
    return [p.dim() >= 2 for p in params]


def add_decayed_weights(grads, params, weight_decay: float, mask=None):
    """``optax.add_decayed_weights(weight_decay, mask)``: g + wd * p, out of
    place, on the tensors ``mask`` keeps (all when None)."""
    if mask is None:
        return torch._foreach_add(grads, params, alpha=weight_decay)
    out = list(grads)
    idx = [i for i, m in enumerate(mask) if m]
    for i, g in zip(idx, torch._foreach_add([grads[i] for i in idx], [params[i] for i in idx],
                                           alpha=weight_decay)):
        out[i] = g
    return out


def clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None):
    """``optax.clip_by_global_norm``: every tensor becomes ``t / norm *
    max_norm`` when the global L2 norm is at least ``max_norm``, and stays
    ``t`` below it; out of place, decided on the device (no host sync): the
    division and the product take 1 in place of norm and max_norm when the
    norm is below, which leaves t exact. (``torch.nn.utils.clip_grad_norm_``
    multiplies by max_norm / (norm + 1e-6) instead.) ``norm``: the global
    norm where ``grads`` are this rank's blocks of sharded leaves."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(grads, torch.where(below, one, norm))
    torch._foreach_mul_(out, torch.where(below, one, torch.full_like(norm, max_norm)))
    return out


class Optimizer:
    """What the optimizers share: the learning rate, a float or a schedule of
    the count (``lr``), and the factory's coupled decay ``l2`` (``wd * p``
    added to the gradient before the optimizer sees it)."""

    def __init__(self, learning_rate: Schedule, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.l2 = weight_decay

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, _zeros(params), _zeros(params))

    def coupled(self, grads, params):
        return add_decayed_weights(grads, params, self.l2) if self.l2 else grads


class AdamW(Optimizer):
    """``optax.adamw`` on a list of fp32 tensors, updated in place.

    mu <- b1 mu + (1 - b1) g;  nu <- b2 nu + (1 - b2) g^2;
    u = mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p;
    p <- p - lr(t - 1) * u
    with t the count after the update: the bias corrections are computed in
    fp32 as optax computes them, eps lies outside the square root, and the
    decay is decoupled (``lr * wd * p``) and applies to every tensor, or
    with ``mask_norms`` to those of 2 or more dims only (optax's ``mask=``,
    build_optimizer's ``wd_mask_norms``).

    ``torch.optim.AdamW`` computes the same update in another order (the
    decay first, as ``p * (1 - lr * wd)``, and the bias corrections in
    float64): three steps on optax's inputs land up to 2 fp32 ulps away
    from optax, where this order agrees within 1e-7.
    """

    def __init__(self, learning_rate: Schedule, weight_decay: float = 1e-4,
                 mask_norms: bool = False):
        super().__init__(learning_rate)
        self.weight_decay = weight_decay
        self.mask_norms = mask_norms

    def _moments(self, grads, state):
        """Adam's moment updates in place; returns mu / (1 - b1^t) /
        (sqrt(nu / (1 - b2^t)) + eps)."""
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
        return upd

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: OptState, params: list[torch.Tensor],
               scale: float = 1.0) -> OptState:
        """Applies one update to ``params`` in place; returns the new state."""
        lr = self.lr(state.count)
        upd = self._moments(grads, state)
        if self.weight_decay:
            if self.mask_norms:
                mask = norms_mask(params)
                torch._foreach_add_(_masked(upd, mask), _masked(params, mask),
                                    alpha=self.weight_decay)
            else:
                torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr * scale)
        return OptState(state.count + 1, state.mu, state.nu)


class Adam(AdamW):
    """``optax.adam``: the AdamW update with no decoupled decay. A nonzero
    ``weight_decay`` is torch Adam's coupled L2 decay, as the JAX factory
    chains it (``optax.add_decayed_weights`` before ``optax.adam``): ``wd * p``
    is added to the gradient before the moments see it."""

    def __init__(self, learning_rate: Schedule, weight_decay: float = 0.0):
        super().__init__(learning_rate, weight_decay=0.0)
        self.l2 = weight_decay

    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        return super().update(self.coupled(grads, params), state, params, scale)


class Adamax(Adam):
    """``optax.adamax``: mu <- b1 mu + (1 - b1) g, nu <- max(|g| + eps, b2 nu)
    (the infinity norm, no bias correction), u = mu / (1 - b1^t) / nu; the
    factory's decay coupled in front."""

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        lr = self.lr(state.count)
        grads = self.coupled(grads, params)
        t = state.count + 1
        mu, nu = state.mu, state.nu
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        mag = torch._foreach_abs(grads)
        torch._foreach_add_(mag, EPS)
        torch._foreach_mul_(nu, B2)
        torch._foreach_maximum_(nu, mag)
        upd = torch._foreach_div(mu, float(1 - np.float32(B1) ** t))
        torch._foreach_div_(upd, nu)
        torch._foreach_add_(params, upd, alpha=-lr * scale)
        return OptState(t, mu, nu)


class SGD(Optimizer):
    """``optax.sgd(lr, momentum, nesterov)``: trace <- g + momentum * trace,
    from a zero trace (so the first update is -lr * g), and p <- p - lr *
    trace, or with ``nesterov`` p <- p - lr * (g + momentum * trace); the
    schedule read at the count before the update; momentum 0 is plain SGD
    (the JAX factory's ``momentum or None``) and keeps no trace, and so is
    the factory's ``asgd``. A nonzero ``weight_decay`` is coupled into the
    gradient, as the JAX factory chains ``optax.add_decayed_weights``
    before it. The trace is the state's ``mu``; ``nu`` is empty."""

    def __init__(self, learning_rate: Schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(learning_rate, weight_decay=weight_decay)
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, _zeros(params) if self.momentum else [], [])

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        lr = self.lr(state.count)
        grads = self.coupled(grads, params)
        trace, upd = state.mu, grads
        if self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            upd = trace
            if self.nesterov:
                upd = torch._foreach_add(grads, trace, alpha=self.momentum)
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr * scale))
        return OptState(state.count + 1, trace, state.nu)


class Adadelta(Optimizer):
    """``optax.adadelta``: e_g <- rho e_g + (1 - rho) g^2, u = sqrt(e_x +
    eps) / sqrt(e_g + eps) * g, e_x <- rho e_x + (1 - rho) u^2, p <- p - lr u
    (e_g is the state's ``mu``, e_x its ``nu``); the decay coupled in front,
    where optax.adadelta takes it."""

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        lr = self.lr(state.count)
        grads = self.coupled(grads, params)
        e_g, e_x = state.mu, state.nu
        rho = ADADELTA_RHO
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, grads, grads, value=1.0 - rho)
        upd = torch._foreach_add(e_x, EPS)
        torch._foreach_sqrt_(upd)
        den = torch._foreach_add(e_g, EPS)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, upd, upd, value=1.0 - rho)
        torch._foreach_add_(params, upd, alpha=-lr * scale)
        return OptState(state.count + 1, e_g, e_x)


class Adagrad(Optimizer):
    """``optax.adagrad(lr, eps=...)``: s <- s + g^2 from s = 0.1 (optax's
    ``initial_accumulator_value``), u = g / sqrt(s + eps) (optax's
    ``where(s > 0, ...)`` always holds from 0.1), p <- p - lr u; ``s`` is
    the state's ``mu``; the decay coupled in front."""

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, [torch.full_like(p, ADAGRAD_INITIAL) for p in params], [])

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        lr = self.lr(state.count)
        grads = self.coupled(grads, params)
        acc = state.mu
        torch._foreach_addcmul_(acc, grads, grads)
        den = torch._foreach_add(acc, EPS)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_div(grads, den)
        torch._foreach_add_(params, upd, alpha=-lr * scale)
        return OptState(state.count + 1, acc, state.nu)


class RMSprop(Optimizer):
    """``optax.rmsprop(lr, decay, eps, centered, momentum)`` with optax's
    defaults: eps inside the square root, nu from 0, no bias correction.
    nu <- a nu + (1 - a) g^2 (and with ``centered`` mu <- a mu + (1 - a) g),
    u = -lr g / sqrt(nu [- mu^2] + eps); with momentum the trace of the
    *scaled* updates, trace <- u + momentum * trace, is the update (the
    factory's ``momentum or None``: momentum 0 keeps no trace). The decay
    is coupled in front."""

    def __init__(self, learning_rate: Schedule, weight_decay: float = 0.0,
                 centered: bool = False, momentum: float = 0.9):
        super().__init__(learning_rate, weight_decay=weight_decay)
        self.centered, self.momentum = centered, momentum

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, _zeros(params) if self.centered else [], _zeros(params),
                        _zeros(params) if self.momentum else [])

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        lr = self.lr(state.count)
        grads = self.coupled(grads, params)
        a = RMSPROP_DECAY
        mu, nu, trace = state.mu, state.nu, state.trace
        torch._foreach_mul_(nu, a)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - a)
        if self.centered:
            torch._foreach_mul_(mu, a)
            torch._foreach_add_(mu, grads, alpha=1.0 - a)
            den = torch._foreach_addcmul(nu, mu, mu, value=-1.0)
        else:
            den = torch._foreach_mul(nu, 1.0)
        torch._foreach_add_(den, EPS)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_div(grads, den)
        if self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, upd, alpha=-lr)
            torch._foreach_add_(params, trace, alpha=scale)
        else:
            torch._foreach_add_(params, upd, alpha=-lr * scale)
        return OptState(state.count + 1, mu, nu, trace)


class Rprop(Optimizer):
    """``optax.rprop`` (0.2.6) with a constant learning rate, the initial
    step size. Per element, with s = g * g_prev: the step grows by 1.2
    where s > 0, shrinks by 0.5 where s < 0 (within ``RPROP_STEP_SIZES``)
    and stays where s = 0; the new g_prev is 0 where s < 0,
    else step * sign(g). The update is p <- p - g_prev(old), 0 where s < 0:
    optax applies the *previous* step's signed step size, so its first
    update is 0. The step sizes are the state's ``mu``, g_prev its ``nu``.
    The factory passes rprop no weight decay. Element-wise selects have no
    ``_foreach`` form: one loop over the tensors."""

    def __init__(self, learning_rate: float):
        if callable(learning_rate):
            raise ValueError("rprop takes a constant learning rate (its initial step size), "
                             "not a schedule: use schedule 'constant' or 'plateau'")
        super().__init__(learning_rate)

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, [torch.full_like(p, self.lr(0)) for p in params], _zeros(params))

    @torch.no_grad()
    def update(self, grads, state, params, scale: float = 1.0) -> OptState:
        eta_minus, eta_plus = RPROP_ETAS
        lo, hi = RPROP_STEP_SIZES
        steps, prevs = [], []
        for g, step, prev, p in zip(grads, state.mu, state.nu, params):
            s = g * prev
            grown = (step * torch.where(s > 0, eta_plus, eta_minus)).clamp_(lo, hi)
            step = torch.where(s == 0, step, grown)
            new_prev = torch.where(s < 0, 0.0, step * torch.sign(g))
            p.sub_(torch.where(s < 0, 0.0, prev), alpha=scale)
            steps.append(step)
            prevs.append(new_prev)
        return OptState(state.count + 1, steps, prevs)


def make_optimizer(name: str, learning_rate: Schedule, *, weight_decay: float = 0.0,
                   momentum: float = 0.9, centered: bool = False,
                   nesterov: bool = False) -> Optimizer:
    """The 9-way optimizer factory (the reference's ``models/utils.py:64-151``),
    with the JAX factory's defaults: ``momentum`` is SGD's and RMSprop's
    (0 keeps no trace), ``centered`` RMSprop's, ``nesterov`` SGD's. An
    unknown name raises ``ValueError``, and so does rprop with a schedule
    (optax raises a TypeError when its state is made)."""
    name = name.lower()
    if name == "adadelta":
        return Adadelta(learning_rate, weight_decay=weight_decay)
    if name == "adagrad":
        return Adagrad(learning_rate, weight_decay=weight_decay)
    if name == "adam":
        return Adam(learning_rate, weight_decay=weight_decay)
    if name == "adamw":
        return AdamW(learning_rate, weight_decay=weight_decay)
    if name == "adamax":
        return Adamax(learning_rate, weight_decay=weight_decay)
    if name == "asgd":  # optax has no ASGD: the JAX factory's plain SGD
        return SGD(learning_rate, momentum=0.0, weight_decay=weight_decay)
    if name == "rmsprop":
        return RMSprop(learning_rate, weight_decay=weight_decay, centered=centered,
                       momentum=momentum)
    if name == "rprop":
        return Rprop(learning_rate)
    if name == "sgd":
        return SGD(learning_rate, momentum=momentum, weight_decay=weight_decay,
                   nesterov=nesterov)
    raise ValueError(f"unsupported optimizer {name!r}")


@dataclasses.dataclass
class ChainState:
    """``Chain``'s state: its optimizer's, and the plateau's scale (None
    when the chain has no plateau stage)."""

    inner: OptState
    scale: Optional[float] = None

    @property
    def count(self) -> int:
        return self.inner.count


class Chain:
    """``build_optimizer``'s stages around a factory optimizer, in JAX's
    ``optax.chain`` order: the global-norm clip (``grad_clip``), a coupled
    decay on the tensors of 2 or more dims (``masked_decay``:
    ``wd_mask_norms`` for every optimizer but AdamW), the optimizer, and
    the plateau's scale (``plateau``: ``inject_hyperparams(optax.scale)``,
    1.0 until the epoch runner sets ``state.scale``)."""

    def __init__(self, optimizer: Optimizer, grad_clip: float = 0.0, masked_decay: float = 0.0,
                 plateau: bool = False):
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.masked_decay = masked_decay
        self.plateau = plateau

    def lr(self, count: int) -> float:
        return self.optimizer.lr(count)

    def init(self, params: list[torch.Tensor]) -> ChainState:
        return ChainState(self.optimizer.init(params), 1.0 if self.plateau else None)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: ChainState,
               params: list[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> ChainState:
        """``grad_norm``: the gradients' global norm, where they are this
        rank's blocks of leaves sharded over the mesh (the clip needs the
        whole gradient's)."""
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip, grad_norm)
        if self.masked_decay:
            grads = add_decayed_weights(grads, params, self.masked_decay, norms_mask(params))
        scale = 1.0 if state.scale is None else state.scale
        return ChainState(self.optimizer.update(grads, state.inner, params, scale), state.scale)


class PlateauScheduler:
    """Host-side ReduceLROnPlateau controller (the JAX package's, as it is):
    ``update(metric)`` returns the learning-rate scale, multiplied by
    ``factor`` (down to ``min_scale``) once the metric has not improved by a
    ``threshold`` share for more than ``patience`` calls in a row; the
    epoch runner writes it into ``ChainState.scale``."""

    def __init__(self, factor: float = 0.1, patience: int = 10, threshold: float = 1e-4,
                 min_scale: float = 1e-8):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale
