"""The training step of the port (port of ``kmunet_tpu/train/engine.py``),
under the JAX engine's names::

    cfg = shanghai_km_unet()
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
(the K4 grouped gather and its K6 backward on the card).

What the port does not have yet raises ``NotImplementedError`` naming its
ROADMAP item: the LAPS variant and ``head_norm`` (Queue 1 item 3), the other
models (item 10), losses, optimizers and schedules (item 5),
``kan_reg_weight`` (item 4), and ``remat``, ``grad_clip`` and
``wd_mask_norms`` (item 8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch import nn

from kmunet_tpu_torch.configs import ExperimentConfig
from kmunet_tpu_torch.losses import hybrid_loss
from kmunet_tpu_torch.models.km_unet import KM_UNetV3, init_weights_
from kmunet_tpu_torch.serve import resolve_device
from kmunet_tpu_torch.train.optimizers import AdamW, AdamWState, make_optimizer
from kmunet_tpu_torch.train.schedule import cosine_annealing_per_epoch

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
    opt_state: AdamWState


def build_model(cfg: ExperimentConfig, dysample_window: bool = True) -> KM_UNetV3:
    """KM_UNetV3-SH of ``cfg.model``; ``dysample_window=False`` takes
    DySample's exact path (the JAX package's ``DYSAMPLE_WINDOW``, which its
    config does not carry either)."""
    m = cfg.model
    if m.name != "km_unet_v3" or m.variant != "sh":
        raise NotImplementedError(
            f"model {m.name!r} variant {m.variant!r}: not in the port yet; the LAPS variant "
            "is ROADMAP Queue 1 item 3, the other models item 10")
    extra = dict(m.extra)
    drop_path = float(extra.pop("drop_path", 0.1))
    if extra:
        raise NotImplementedError(f"model.extra {sorted(extra)}: not in the port yet; "
                                  "head_norm is ROADMAP Queue 1 item 3")
    return KM_UNetV3(num_classes=m.num_classes, embed_dims=tuple(m.embed_dims),
                     drop_path=drop_path, dysample_window=dysample_window)


def build_loss(cfg: ExperimentConfig) -> Callable:
    if cfg.train.loss != "hybrid":
        raise NotImplementedError(f"loss {cfg.train.loss!r}: the port has hybrid only "
                                  "(ROADMAP Queue 1 item 5)")
    return functools.partial(hybrid_loss, alpha=cfg.train.loss_alpha)


def build_optimizer(cfg: ExperimentConfig, steps_per_epoch: int) -> AdamW:
    t = cfg.train
    if t.grad_clip:
        raise NotImplementedError("grad_clip: not in the port yet (ROADMAP Queue 1 item 8)")
    if t.wd_mask_norms:
        raise NotImplementedError("wd_mask_norms: not in the port yet (ROADMAP Queue 1 item 8)")
    if t.schedule != "cosine_epoch":
        raise NotImplementedError(f"schedule {t.schedule!r}: the port has cosine_epoch only "
                                  "(ROADMAP Queue 1 item 5)")
    sched = cosine_annealing_per_epoch(t.lr, t.eta_min, t.cosine_t_max, steps_per_epoch)
    return make_optimizer(t.optimizer, sched, weight_decay=t.weight_decay)


def init_state(cfg: ExperimentConfig, model: nn.Module, tx: AdamW, seed: int = 0,
               device=None) -> TrainState:
    """Initialises ``model`` from ``seed`` with the JAX package's
    distributions, moves it to ``device`` (None: the card, which must exist)
    in training mode, and returns the state that aliases its tensors."""
    device = resolve_device(device)
    init_weights_(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=torch.float32).train()
    params = dict(model.named_parameters())
    batch_stats = {k: b for k, b in model.named_buffers() if not k.endswith("num_batches_tracked")}
    return TrainState(0, params, batch_stats, tx.init(list(params.values())))


def _split_batch(batch: torch.Tensor, in_frames: int, out_frames: int):
    """(B, seq, H, W) -> NHWC model input (B, H, W, in_frames) and the
    (B, out_frames, H, W) target."""
    tgt = batch[:, in_frames:in_frames + out_frames]
    return batch[:, :in_frames].permute(0, 2, 3, 1), tgt


def make_loss_of(model: nn.Module, loss_fn: Callable, cfg: ExperimentConfig):
    """``loss_of(params, batch, generator) -> loss``, the computation the step
    differentiates. The AMP analogue is the JAX package's own: every
    floating parameter is cast to the compute dtype inside the graph, the
    input too, and the output back to fp32 before the loss, so the master
    parameters and their gradients stay fp32. (``torch.autocast`` would keep
    some ops in fp32 and compute another function.) The BatchNorm running
    buffers are updated in place on ``model``."""
    if cfg.train.remat:
        raise NotImplementedError("remat: not in the port yet (ROADMAP Queue 1 item 8)")
    if cfg.train.kan_reg_weight:
        raise NotImplementedError("kan_reg_weight: needs kan_regularization_loss "
                                  "(ROADMAP Queue 1 item 4)")
    if cfg.train.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {list(_COMPUTE_DTYPES)}")
    cdtype = _COMPUTE_DTYPES[cfg.train.compute_dtype]
    in_f, out_f = cfg.data.in_frames, cfg.data.out_frames

    def loss_of(params: dict, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        inp, tgt = _split_batch(batch, in_f, out_f)
        params_c = {k: p.to(cdtype) if p.is_floating_point() else p for k, p in params.items()}
        out = torch.func.functional_call(model, params_c, (inp.to(cdtype),),
                                         {"generator": generator})
        pred = out.float().permute(0, 3, 1, 2)  # (B, T, H, W)
        return loss_fn(pred, tgt)

    return loss_of


def make_train_step(model: nn.Module, loss_fn: Callable, tx: AdamW, cfg: ExperimentConfig):
    """``step(state, batch, generator) -> (state, {"loss", "grad_norm"})``:
    one AdamW step on ``batch`` (B, seq_len, H, W), a tensor or array moved
    to the model's device as fp32. The metrics are 0-d tensors on that
    device (reading them waits for it); ``grad_norm`` is the global L2 norm
    of the fp32 gradients."""
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
