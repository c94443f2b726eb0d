"""The training step of the port (port of ``kmunet_tpu/train/engine.py``),
under the JAX engine's names::

    cfg = shanghai_km_unet()          # or laps_km_unet(), apply_recipe(shanghai_km_unet(), ...)
    model = build_model(cfg)
    loss_fn = build_loss(cfg)
    tx = build_optimizer(cfg, steps_per_epoch=100)
    state = init_state(cfg, model, tx, seed=0)           # on "cuda"; raises without a card
    step = make_train_step(model, loss_fn, tx, cfg)
    state, metrics = step(state, batch, generator)      # batch (B, seq_len, H, W)

Pass ``device="cpu"`` to ``init_state`` to train on the CPU (the gather then
takes its plain versions); nothing falls back to the CPU on its own. The
``generator`` (on the model's device) feeds DropPath; it may be None when
``model.extra["drop_path"]`` is 0.

``build_model(cfg, dysample_window=False)`` takes DySample's exact path
(the K4 grouped gather and its K6 backward on the card); ``kan_fused=True``
and ``ssd_mixer="fused"`` (or ``"compress"``) run KM_UNetV3's KAN convs and
HSM-SSD mixers through K1 and K3 (or K2), their backward the autograd of the
plain versions. The models come
from the zoo (``models/zoo.py``): KM_UNetV3 in its SH or LAPS variant
(``cfg.model.variant``; ``laps_km_unet()`` is the LAPS recipe, 5 -> 3 frames
at B=1, with the SH recipe's loss and optimizer) with ``model.extra``'s
``drop_path`` and ``head_norm``, the sequence models
ConvLSTM and TrajGRU, and Mamba-UNet (``cfg.model.name``;
``train/recipes.py::apply_recipe`` sets their reference recipes: Adam,
``weighted_mse_mae`` and MultiStepLR for the RNNs; SGD with momentum,
``rainfall_loss`` and CosineAnnealingLR for Mamba-UNet's "pic"). TrajGRU's
warp runs K7 and its backward K6's shared-source entry; Mamba-UNet's scans
run K8 and its backward. Mamba-UNet has no BatchNorm and no stochastic
depth: its ``batch_stats`` are empty and the generator may be None.

Every option of the JAX engine's step is here: every ``loss``
(``build_loss``), every ``optimizer`` and ``schedule`` of the JAX factories
with ``grad_clip``, ``wd_mask_norms`` and ``plateau`` (``build_optimizer``;
``schedule="plateau"`` holds its scale in ``state.opt_state.scale``, 1.0
until a caller sets it from ``optimizers.PlateauScheduler``), ``remat`` and
``kan_reg_weight`` (``make_loss_of``). What the port does not have yet
raises ``NotImplementedError`` naming its ROADMAP Queue 1 item: the other
models (item 10). The epoch runner, which consults the plateau between
epochs, and the evaluation with ``scatter_eval`` are item 8's second half
and item 6.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Union

import torch
import torch.utils.checkpoint
from torch import nn

from kmunet_tpu_torch.configs import ExperimentConfig
from kmunet_tpu_torch.losses import hybrid_loss, rain_loss, rainfall_loss, weighted_mse_mae
from kmunet_tpu_torch.models import zoo
from kmunet_tpu_torch.nn.kan import kan_regularization_loss
from kmunet_tpu_torch.serve import resolve_device
from kmunet_tpu_torch.train.optimizers import AdamW, Chain, Optimizer, make_optimizer
from kmunet_tpu_torch.train.schedule import cosine_annealing_per_epoch, make_schedule

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates. ``params`` are the model's own fp32
    parameters and ``batch_stats`` its BatchNorm running buffers, by
    state_dict name: the model always holds the current weights, and the
    step updates them in place (the JAX step donates its state)."""

    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: Any  # the optimizer's: optimizers.OptState, or ChainState


def build_model(cfg: ExperimentConfig, dysample_window: bool = True, kan_fused: bool = False,
                ssd_mixer: str = "einsum") -> nn.Module:
    """The zoo's model of ``cfg.model``; ``dysample_window=False`` takes
    KM_UNetV3's DySample exact path (the JAX package's ``DYSAMPLE_WINDOW``,
    which its config does not carry either); ``kan_fused`` and ``ssd_mixer``
    as in ``KM_UNetV3``."""
    return zoo.build(cfg.model, dysample_window=dysample_window, kan_fused=kan_fused,
                     ssd_mixer=ssd_mixer)


def build_loss(cfg: ExperimentConfig) -> Callable:
    """``loss(pred, target)`` on (B, T, H, W) maps."""
    name = cfg.train.loss
    if name == "hybrid":
        return functools.partial(hybrid_loss, alpha=cfg.train.loss_alpha)
    if name == "rainfall":
        return rainfall_loss
    if name == "rain":
        return rain_loss
    if name == "weighted_mse_mae":
        thresholds = tuple(cfg.data.thresholds)
        # The loss keeps the reference's (B, S, C, H, W) contract: the
        # (B, T, H, W) maps get the singleton channel axis.
        return lambda p, t: weighted_mse_mae(p[:, :, None], t[:, :, None], lam=None,
                                             thresholds=thresholds)
    if name == "mse":
        return lambda p, t: torch.mean((p - t) ** 2)
    raise ValueError(f"unknown loss {name}")


def build_optimizer(cfg: ExperimentConfig, steps_per_epoch: int) -> Union[Optimizer, Chain]:
    """The JAX engine's optimizer for ``cfg.train``: the schedule
    (``cosine_epoch``, ``constant`` and ``plateau`` at a constant lr, or a
    name of ``make_schedule``), the factory's optimizer, and around it, in
    JAX's order, the global-norm clip (``grad_clip``), ``wd_mask_norms``
    (AdamW decays the tensors of 2 or more dims only; every other optimizer
    gets a coupled decay on them in front and none of its own, rprop
    included, which otherwise has none) and the plateau's scale. Without
    those options, the factory's optimizer itself. rprop with a schedule
    raises ``ValueError`` (JAX's step fails on it when its state is made)."""
    t = cfg.train
    if t.schedule == "cosine_epoch":
        sched = cosine_annealing_per_epoch(t.lr, t.eta_min, t.cosine_t_max, steps_per_epoch)
    elif t.schedule in ("constant", "plateau"):
        sched = t.lr
    else:
        sched = make_schedule(t.schedule, t.lr, steps_per_epoch,
                              milestones=tuple(t.milestones), gamma=t.gamma,
                              t_max=t.cosine_t_max, eta_min=t.eta_min, epochs=t.epochs)
    wd, masked_decay = t.weight_decay, 0.0
    if wd and t.wd_mask_norms:
        if t.optimizer == "adamw":
            opt = AdamW(sched, weight_decay=wd, mask_norms=True)
        else:
            opt = make_optimizer(t.optimizer, sched, weight_decay=0.0, momentum=t.momentum)
            masked_decay = wd
    else:
        opt = make_optimizer(t.optimizer, sched, weight_decay=wd, momentum=t.momentum)
    plateau = t.schedule == "plateau"
    if t.grad_clip or masked_decay or plateau:
        return Chain(opt, grad_clip=t.grad_clip, masked_decay=masked_decay, plateau=plateau)
    return opt


def init_state(cfg: ExperimentConfig, model: nn.Module, tx, seed: int = 0,
               device=None) -> TrainState:
    """Initialises ``model`` from ``seed`` with the JAX package's
    distributions, moves it to ``device`` (None: the card, which must exist)
    in training mode, and returns the state that aliases its tensors."""
    device = resolve_device(device)
    zoo.init_weights_(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=torch.float32).train()
    params = dict(model.named_parameters())
    batch_stats = {k: b for k, b in model.named_buffers() if not k.endswith("num_batches_tracked")}
    return TrainState(0, params, batch_stats, tx.init(list(params.values())))


def _model_layout(cfg: ExperimentConfig) -> str:
    """'seq' for the sequence models (``zoo.SEQUENCE_MODELS``), else 'stack'."""
    return "seq" if cfg.model.name in zoo.SEQUENCE_MODELS else "stack"


def _split_batch(batch: torch.Tensor, in_frames: int, out_frames: int, layout: str = "stack"):
    """(B, seq, H, W) -> the model input and the (B, out_frames, H, W)
    target. Layout 'stack': the input frames as NHWC channels (B, H, W,
    in_frames); 'seq': the (B, in_frames, H, W) sequence."""
    tgt = batch[:, in_frames:in_frames + out_frames]
    if layout == "seq":
        return batch[:, :in_frames], tgt
    return batch[:, :in_frames].permute(0, 2, 3, 1), tgt


def _to_btHW(out: torch.Tensor, layout: str) -> torch.Tensor:
    """Model output -> (B, T, H, W): 'stack' models return NHWC with T as
    channels, 'seq' models (B, T, H, W) already."""
    return out.permute(0, 3, 1, 2) if layout == "stack" else out


def _remat_forward(model: nn.Module, params_c: dict, inp: torch.Tensor,
                   generator: Optional[torch.Generator], kwargs: dict) -> torch.Tensor:
    """The forward under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped and recomputed in the backward, as
    ``jax.checkpoint`` does, computing the same function. Two things the
    checkpoint leaves to its caller are handled here for the recompute:
    ``generator`` (DropPath's) replays from its state at the start of the
    forward and is put back where the backward found it (``checkpoint``
    restores only the default generators), and the BatchNorm running
    buffers, which the forward moved in place, are put back after it, so
    that they move once per step. Both hold if the recompute stops early."""
    names = list(params_c)
    buffers = [b for k, b in model.named_buffers() if not k.endswith("num_batches_tracked")]
    start = None if generator is None else generator.get_state()
    calls = 0

    def forward(x, *values):
        nonlocal calls
        calls += 1
        if calls == 1:
            return torch.func.functional_call(model, dict(zip(names, values)), (x,), kwargs)
        stats = [b.clone() for b in buffers]
        found = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(start)
        try:
            return torch.func.functional_call(model, dict(zip(names, values)), (x,), kwargs)
        finally:
            for b, kept in zip(buffers, stats):
                b.copy_(kept)
            if generator is not None:
                generator.set_state(found)

    return torch.utils.checkpoint.checkpoint(forward, inp, *params_c.values(),
                                             use_reentrant=False, preserve_rng_state=False)


def make_loss_of(model: nn.Module, loss_fn: Callable, cfg: ExperimentConfig):
    """``loss_of(params, batch, generator) -> loss``, the computation the step
    differentiates. The AMP analogue is the JAX package's own: every
    floating parameter is cast to the compute dtype inside the graph, the
    input too, and the output back to fp32 before the loss, so the master
    parameters and their gradients stay fp32. (``torch.autocast`` would keep
    some ops in fp32 and compute another function.) The BatchNorm running
    buffers are updated in place on ``model``. ``remat`` recomputes the
    forward in the backward (``_remat_forward``); ``kan_reg_weight`` adds
    that weight times ``kan_regularization_loss`` of the fp32 ``params``
    (not of their compute-dtype copies), as JAX does."""
    if cfg.train.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {list(_COMPUTE_DTYPES)}")
    cdtype = _COMPUTE_DTYPES[cfg.train.compute_dtype]
    in_f, out_f = cfg.data.in_frames, cfg.data.out_frames
    layout = _model_layout(cfg)
    takes_generator = cfg.model.name == "km_unet_v3"
    remat, kan_reg_weight = cfg.train.remat, cfg.train.kan_reg_weight

    def loss_of(params: dict, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inp, tgt = _split_batch(batch, in_f, out_f, layout)
        params_c = {k: p.to(cdtype) if p.is_floating_point() else p for k, p in params.items()}
        # KM_UNetV3's stochastic depth takes the generator; the other
        # models have none.
        kwargs = {"generator": generator} if takes_generator else {}
        if remat:
            out = _remat_forward(model, params_c, inp.to(cdtype),
                                 generator if takes_generator else None, kwargs)
        else:
            out = torch.func.functional_call(model, params_c, (inp.to(cdtype),), kwargs)
        loss = loss_fn(_to_btHW(out.float(), layout), tgt)
        if kan_reg_weight:
            loss = loss + kan_reg_weight * kan_regularization_loss(params)
        return loss

    return loss_of


def make_train_step(model: nn.Module, loss_fn: Callable, tx, cfg: ExperimentConfig):
    """``step(state, batch, generator) -> (state, {"loss", "grad_norm"})``:
    one update of ``tx`` (``build_optimizer``'s) on ``batch`` (B, seq_len,
    H, W), a tensor or array moved to the model's device as fp32. The
    metrics are 0-d tensors on that device (reading them waits for it);
    ``grad_norm`` is the global L2 norm of the fp32 gradients, before any
    clip, as JAX reports it."""
    loss_of = make_loss_of(model, loss_fn, cfg)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        params = list(state.params.values())
        batch = torch.as_tensor(batch).to(device=params[0].device, dtype=torch.float32)
        loss = loss_of(state.params, batch, generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        opt_state = tx.update(list(grads), state.opt_state, params)
        new_state = TrainState(state.step + 1, state.params, state.batch_stats, opt_state)
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
