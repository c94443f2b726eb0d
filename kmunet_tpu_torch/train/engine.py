"""The training and evaluation engine of the port (port of
``kmunet_tpu/train/engine.py``), under the JAX engine's names.

Training and scoring a model end to end, as ``python -m
kmunet_tpu.train.engine`` does::

    cfg = shanghai_km_unet()          # or laps_km_unet(); parse_overrides(cfg, argv)
    results = train_and_evaluate(cfg)                    # on "cuda"; raises without a card
    results = evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="best")
    python -m kmunet_tpu_torch.train.engine --config=synthetic --max_steps=2

``train_and_evaluate`` builds the datasets and loaders, trains epoch after
epoch (the losses stay on the device until the epoch ends), validates,
consults the plateau controller, stops early or on a non-finite loss,
checkpoints the best state by val loss, runs the test pass through the
streaming ``Evaluator`` (with the scatter metrics where ``scatter_eval``)
and writes ``results.json`` and the epoch CSV. ``data.device_cache`` keeps
the train and val corpora on the device and gathers each batch there
(``make_epoch_runner``, ``make_val_epoch``). ``train_and_evaluate``'s and
``evaluate_checkpoint``'s keyword arguments (``dysample_window``,
``kan_fused``, ``ssd_mixer``) go to ``build_model``.

The pieces, for one step at a time::

    model = build_model(cfg)
    loss_fn = build_loss(cfg)
    tx = build_optimizer(cfg, steps_per_epoch=100)
    state = init_state(cfg, model, tx, seed=0)           # on "cuda"; raises without a card
    step = make_train_step(model, loss_fn, tx, cfg)
    state, metrics = step(state, batch, generator)      # batch (B, seq_len, H, W)
    loss, pred, target = make_eval_step(model, loss_fn, cfg)(state, batch)

Pass ``device="cpu"`` to run on the CPU (the gathers then take their plain
versions); nothing falls back to the CPU on its own. The ``generator`` (on
the model's device) feeds DropPath; it may be None when
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
``schedule="plateau"`` holds its scale in ``state.opt_state.scale``, which
the epoch loop sets from ``optimizers.PlateauScheduler``), ``remat`` and
``kan_reg_weight`` (``make_loss_of``). Where the port departs from the JAX
engine: checkpoints are torch files (``train/checkpoint.py``) with orbax's
retention; a resumed run goes on from the epoch after its checkpoint's,
with the loader's epoch count, the generator's state and the plateau
controller's as they were (JAX counts its epochs from 0 again); and the
device-cache epoch draws its permutation from a ``torch.Generator``, not a
JAX PRNG. What the port does not have yet raises ``NotImplementedError``
naming its ROADMAP Queue 1 item: the other models (item 10) and
H-sharded activations (``mesh.spatial`` > 1, item 9b).

Across cards: one process per card (``torchrun --nproc_per_node=N -m
kmunet_tpu_torch.train.engine ...``), over the mesh of ``cfg.mesh``
(``build_mesh``): data parallelism with BatchNorm and DropPath over the
global batch, and with ``mesh.fsdp`` the larger parameters sharded over
'model' (``init_state(..., mesh=)``, ``make_train_step``).
"""

from __future__ import annotations

import csv
import dataclasses
import functools
import json
import math
import os
import sys
import time
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from kmunet_tpu_torch.configs import (ExperimentConfig, laps_km_unet, parse_overrides,
                                      shanghai_km_unet)
from kmunet_tpu_torch.data import (DataLoader, LAPSDataset, ShanghaiDataset,
                                   SyntheticNowcastDataset, split_indices)
from kmunet_tpu_torch.losses import hybrid_loss, rain_loss, rainfall_loss, weighted_mse_mae
from kmunet_tpu_torch.metrics import Evaluator, make_lpips_fn, scatter_evaluate
from kmunet_tpu_torch.models import zoo
from kmunet_tpu_torch.nn.kan import kan_regularization_loss
from kmunet_tpu_torch.nn.layers import set_data_axis
from kmunet_tpu_torch.parallel import (Mesh, MeshSpec, batch_sharding, init_distributed,
                                       make_mesh, param_sharding_rules, shard_params)
from kmunet_tpu_torch.parallel.collectives import (all_reduce_, all_reduce_many_, gather,
                                                   reduce_scatter_mean)
from kmunet_tpu_torch.parallel.mesh import REPLICA
from kmunet_tpu_torch.serve import resolve_device
from kmunet_tpu_torch.train.checkpoint import CheckpointManager
from kmunet_tpu_torch.train.optimizers import (AdamW, Chain, Optimizer, PlateauScheduler,
                                               make_optimizer)
from kmunet_tpu_torch.train.schedule import cosine_annealing_per_epoch, make_schedule

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates. ``params`` are the model's own fp32
    parameters and ``batch_stats`` its BatchNorm running buffers, by
    state_dict name: the model always holds the current weights, and the
    step updates them in place (the JAX step donates its state).

    ``mesh`` is the run's ``parallel.Mesh`` (None: one process). ``shards``
    maps each parameter sharded over the mesh's 'model' axis (``fsdp``) to
    the dim it is cut on: ``params`` (and the model, and the optimizer's
    slots) hold only this rank's block of it."""

    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: Any  # the optimizer's: optimizers.OptState, or ChainState
    shards: dict[str, int] = dataclasses.field(default_factory=dict)
    mesh: Optional[Mesh] = None

    @property
    def distributed(self) -> bool:
        """True when the step's collectives run (a mesh with process groups)."""
        return self.mesh is not None and self.mesh.axis(REPLICA).group is not None


def full_params(state: TrainState) -> dict[str, torch.Tensor]:
    """The whole parameters: each sharded leaf gathered over the 'model'
    axis (a new leaf that takes a gradient), the others as they are."""
    if not state.shards:
        return state.params
    ax = state.mesh.axis("model")
    return {k: p if k not in state.shards
            else gather(p.detach(), ax, dim=state.shards[k]).requires_grad_()
            for k, p in state.params.items()}


def build_model(cfg: ExperimentConfig, dysample_window: bool = True, kan_fused: bool = False,
                ssd_mixer: str = "einsum") -> nn.Module:
    """The zoo's model of ``cfg.model``; ``dysample_window=False`` takes
    KM_UNetV3's DySample exact path (the JAX package's ``DYSAMPLE_WINDOW``,
    which its config does not carry either); ``kan_fused`` and ``ssd_mixer``
    as in ``KM_UNetV3``."""
    return zoo.build(cfg.model, dysample_window=dysample_window, kan_fused=kan_fused,
                     ssd_mixer=ssd_mixer)


def build_loss(cfg: ExperimentConfig, mesh: Optional[Mesh] = None) -> Callable:
    """``loss(pred, target)`` on (B, T, H, W) maps. In a data-parallel run
    (``mesh``) it is this rank's rows' share of the global batch's loss: the
    mean of the ranks' losses is the global batch's (the hybrid loss takes
    its min-max bounds over the data axis; the others are means or sums over
    rows of equal counts)."""
    name = cfg.train.loss
    if name == "hybrid":
        axis = None if mesh is None else mesh.axis("data")
        return functools.partial(hybrid_loss, alpha=cfg.train.loss_alpha,
                                 data_axis=axis if axis is not None and axis.group is not None
                                 else None)
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
               device=None, mesh: Optional[Mesh] = None) -> TrainState:
    """Initialises ``model`` from ``seed`` with the JAX package's
    distributions, moves it to ``device`` (None: the card, which must exist)
    in training mode, and returns the state that aliases its tensors,
    placed on ``mesh`` where one is given (``place_state``)."""
    device = resolve_device(device)
    zoo.init_weights_(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=torch.float32).train()
    params = dict(model.named_parameters())
    batch_stats = {k: b for k, b in model.named_buffers() if not k.endswith("num_batches_tracked")}
    state = TrainState(0, params, batch_stats, tx.init(list(params.values())))
    return state if mesh is None else place_state(cfg, model, tx, state, mesh)


def place_state(cfg: ExperimentConfig, model: nn.Module, tx, state: TrainState,
                mesh: Mesh) -> TrainState:
    """A fresh ``state`` of ``model`` (every rank's the same) on ``mesh``.
    With several processes the BatchNorms and DropPaths work over the
    global batch (``nn.layers.set_data_axis``), and with ``cfg.mesh.fsdp``
    the leaves that ``param_sharding_rules`` picks are cut over the 'model'
    axis: the model's parameter becomes this rank's block, and the
    optimizer's slots are made anew for the blocks."""
    if mesh.axis(REPLICA).group is None:  # one process: nothing to place
        return dataclasses.replace(state, mesh=mesh)
    set_data_axis(model, mesh.axis("data"))
    shards = {}
    if cfg.mesh.fsdp:
        rules = param_sharding_rules(mesh, state.params, fsdp=True)
        shards = {k: a for k, a in rules.items() if a is not None}
        blocks = shard_params({k: state.params[k].detach() for k in shards}, shards, mesh)
        for name, block in blocks.items():
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf, nn.Parameter(block))
    params = dict(model.named_parameters())
    opt_state = tx.init(list(params.values())) if shards else state.opt_state
    return dataclasses.replace(state, params=params, opt_state=opt_state, shards=shards,
                               mesh=mesh)


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


def _reduce_gradients(state: TrainState, grads: list[torch.Tensor]):
    """The gradients of the global batch's loss from this rank's, and their
    global norm. A replicated leaf's are averaged over the data x model
    ranks (one flat collective; the model ranks of one data index hold the
    same values, and the average keeps every rank's bits equal); a sharded
    leaf's are reduce-scattered over 'model' to this rank's block, then
    averaged over 'data'. The norm adds the blocks' squares over 'model'."""
    mesh, names = state.mesh, list(state.params)
    replicated = [g for k, g in zip(names, grads) if k not in state.shards]
    all_reduce_many_(replicated, mesh.axis(REPLICA), mean=True)
    if not state.shards:
        return grads, torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    model_ax = mesh.axis("model")
    grads = [g if k not in state.shards else reduce_scatter_mean(g, model_ax, state.shards[k])
             for k, g in zip(names, grads)]
    blocks = [g for k, g in zip(names, grads) if k in state.shards]
    all_reduce_many_(blocks, mesh.axis("data"), mean=True)
    squares = torch.stack(torch._foreach_norm(blocks)).square().sum()
    all_reduce_(squares, model_ax)
    if replicated:
        squares = squares + torch.stack(torch._foreach_norm(replicated)).square().sum()
    return grads, squares.sqrt()


def make_train_step(model: nn.Module, loss_fn: Callable, tx, cfg: ExperimentConfig):
    """``step(state, batch, generator) -> (state, {"loss", "grad_norm"})``:
    one update of ``tx`` (``build_optimizer``'s) on ``batch`` (B, seq_len,
    H, W), a tensor or array moved to the model's device as fp32. The
    metrics are 0-d tensors on that device (reading them waits for it);
    ``grad_norm`` is the global L2 norm of the fp32 gradients, before any
    clip, as JAX reports it.

    In a data-parallel run (``state.mesh``) ``batch`` is this rank's rows of
    the global batch (``parallel.batch_sharding``, the loaders' blocks): the
    sharded leaves are gathered before the forward, the gradients reduced
    over the ranks (``_reduce_gradients``), the clip takes the global norm,
    and the reported loss is the data ranks' mean, the same on every rank.
    (``nn.parallel.DistributedDataParallel`` hooks the module's own
    backward; this step differentiates a functional call.)"""
    loss_of = make_loss_of(model, loss_fn, cfg)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        params = list(state.params.values())
        batch = torch.as_tensor(batch).to(device=params[0].device, dtype=torch.float32)
        if not state.distributed:
            loss = loss_of(state.params, batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
            grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            opt_state = tx.update(list(grads), state.opt_state, params)
            return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), {
                "loss": loss.detach(), "grad_norm": grad_norm}
        whole = full_params(state)
        loss = loss_of(whole, batch, generator)
        grads = list(torch.autograd.grad(loss, list(whole.values()), allow_unused=True,
                                         materialize_grads=True))
        grads, grad_norm = _reduce_gradients(state, grads)
        loss = all_reduce_(loss.detach().clone(), state.mesh.axis(REPLICA), mean=True)
        norm = {"grad_norm": grad_norm} if isinstance(tx, Chain) else {}
        opt_state = tx.update(grads, state.opt_state, params, **norm)
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), {
            "loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable, cfg: ExperimentConfig):
    """``eval_step(state, batch) -> (loss, pred, target)``: the model in eval
    mode (BatchNorm on its running statistics, no stochastic depth) on its
    fp32 parameters (the sharded ones gathered), as JAX evaluates, with no
    gradient; pred and target (B, out_frames, H, W) fp32 on the model's
    device. In a data-parallel run ``batch`` and the outputs are this
    rank's rows, and the loss is this rank's share (``build_loss``)."""
    in_f, out_f = cfg.data.in_frames, cfg.data.out_frames
    layout = _model_layout(cfg)

    def eval_step(state: TrainState, batch):
        device = next(iter(state.params.values())).device
        batch = torch.as_tensor(batch).to(device=device, dtype=torch.float32)
        inp, tgt = _split_batch(batch, in_f, out_f, layout)
        training = model.training
        model.eval()
        try:
            with torch.no_grad():
                if state.shards:
                    out = torch.func.functional_call(model, full_params(state), (inp,))
                else:
                    out = model(inp)
        finally:
            model.train(training)
        pred = _to_btHW(out.float(), layout)
        return loss_fn(pred, tgt), pred, tgt

    return eval_step


def make_epoch_runner(model: nn.Module, loss_fn: Callable, tx, cfg: ExperimentConfig,
                      n_batches: int):
    """``run_epoch(state, data, generator) -> (state, mean loss)``: one
    training epoch over a corpus ``data`` (N, seq_len, H, W) on the device,
    its batches gathered there in the order of ``torch.randperm`` drawn from
    ``generator`` (which also feeds DropPath), with no host copy and no
    host sync; the mean loss is a 0-d tensor on the device. (JAX's runner
    draws its permutation from a JAX PRNG: the same distribution, another
    stream.) In a data-parallel run every rank holds the corpus and draws
    the same permutation, and gathers its rows of each global batch."""
    step = make_train_step(model, loss_fn, tx, cfg)
    B = cfg.data.batch_size

    def run_epoch(state: TrainState, data: torch.Tensor, generator: torch.Generator):
        perm = torch.randperm(data.shape[0], generator=generator, device=data.device)
        losses = []
        for ib in perm[:n_batches * B].view(n_batches, B):
            if state.mesh is not None:
                ib = batch_sharding(state.mesh, ib)
            state, m = step(state, data.index_select(0, ib), generator)
            losses.append(m["loss"])
        return state, torch.stack(losses).mean()

    return run_epoch


def make_val_epoch(model: nn.Module, loss_fn: Callable, cfg: ExperimentConfig, n_batches: int):
    """``run_val(state, data) -> mean loss``: the eval step over the first
    ``n_batches`` batches of a corpus on the device, in order; a 0-d tensor
    on the device. In a data-parallel run each rank evaluates its rows of
    each batch, and the mean is over the data ranks too."""
    eval_step = make_eval_step(model, loss_fn, cfg)
    B = cfg.data.batch_size

    def run_val(state: TrainState, data: torch.Tensor) -> torch.Tensor:
        rows = (lambda b: b) if state.mesh is None else functools.partial(batch_sharding,
                                                                         state.mesh)
        return _data_mean(state.mesh, torch.stack(
            [eval_step(state, rows(data[i * B:(i + 1) * B]))[0] for i in range(n_batches)]).mean())

    return run_val


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def build_datasets(cfg: ExperimentConfig):
    """(train, val, test) datasets of ``cfg.data.name``: synthetic (train of
    ``synthetic_length`` items, val and test of a quarter of it or a batch,
    from seeds 0, 1, 2), shanghai (the 60/20/20 split of the file's train
    group) or laps (its 80/10/10 windows)."""
    d = cfg.data
    if d.name == "synthetic":
        def mk(n, seed):
            return SyntheticNowcastDataset(length=n, img_size=d.img_size, seq_len=d.seq_len,
                                           seed=seed)

        n_eval = max(d.synthetic_length // 4, d.batch_size)
        return mk(d.synthetic_length, 0), mk(n_eval, 1), mk(n_eval, 2)
    if d.name == "shanghai":
        base = ShanghaiDataset(d.path, d.img_size, "train")
        splits = split_indices(base.all_len)
        base.close()
        return tuple(ShanghaiDataset(d.path, d.img_size, "train", indices=idx) for idx in splits)
    if d.name == "laps":
        return tuple(LAPSDataset(d.path, d.seq_len, split) for split in ("train", "val", "test"))
    raise ValueError(f"unknown dataset {d.name}")


def build_mesh(cfg: ExperimentConfig, device=None) -> tuple[Mesh, torch.device]:
    """(the mesh of ``cfg.mesh``, this process's device): joins the run's
    process group (``parallel.init_distributed``: NCCL on the card under
    ``torchrun``, gloo for ``device="cpu"``, none for one process) and makes
    the mesh over its ranks, which raises ``ValueError`` as JAX's
    ``MeshSpec.resolve`` does where the world cannot fill it. H-sharded
    activations (``spatial`` > 1) raise ``NotImplementedError``."""
    m = cfg.mesh
    if m.spatial not in (-1, 1):
        raise NotImplementedError(f"mesh {m}: KM_UNetV3's activations sharded on H (the halo "
                                  "exchanges, the gathers across row boundaries and the "
                                  "reductions over L) are ROADMAP Queue 1 item 9b")
    device = init_distributed(device)
    mesh = make_mesh(MeshSpec(m.data, m.spatial, m.model))
    if mesh.shape["spatial"] > 1:
        raise NotImplementedError(f"mesh {mesh.shape}: H-sharded activations are ROADMAP "
                                  "Queue 1 item 9b")
    return mesh, device


def _data_mean(mesh: Optional[Mesh], value: torch.Tensor) -> torch.Tensor:
    """The mean of ``value`` over the mesh's data x model ranks (the same on
    every rank), or ``value`` in a run of one process."""
    if mesh is None:
        return value
    return all_reduce_(value.detach().clone(), mesh.axis(REPLICA), mean=True)


def _lead(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes the logs, the files and the strips."""
    return mesh is None or mesh.rank == 0


def _loader(cfg: ExperimentConfig, dataset, shuffle: bool, device, mesh=None) -> DataLoader:
    return DataLoader(dataset, cfg.data.batch_size, shuffle=shuffle, seed=cfg.train.seed,
                      num_workers=cfg.data.num_workers, device=device, mesh=mesh)


# --------------------------------------------------------------------------
# loop
# --------------------------------------------------------------------------

def _write_results_json(path: str, results: dict, cfg: ExperimentConfig) -> None:
    """results.json: the test metrics and the run's identity, JSON-safe
    (numpy scalars to Python, threshold keys to strings, NaN and Inf to
    strings)."""
    def safe(x):
        if isinstance(x, dict):
            return {str(k): safe(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [safe(v) for v in x]
        if isinstance(x, (np.floating, np.integer)):
            return safe(x.item())
        if isinstance(x, float) and not math.isfinite(x):
            return str(x)
        return x

    history = results.get("history", {})
    payload = {
        "model": cfg.model.name,
        "dataset": cfg.data.name,
        "img_size": cfg.data.img_size,
        "batch_size": cfg.data.batch_size,
        "loss": cfg.train.loss,
        "optimizer": cfg.train.optimizer,
        "lr": cfg.train.lr,
        "compute_dtype": cfg.train.compute_dtype,
        **{k: safe(v) for k, v in results.items() if k != "history"},
        "final_train_loss": safe(history["train_loss"][-1]) if history.get("train_loss") else None,
        "final_val_loss": safe(history["val_loss"][-1]) if history.get("val_loss") else None,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def train_and_evaluate(cfg: ExperimentConfig, max_steps: Optional[int] = None,
                       log_csv: Optional[str] = None, device=None, **build_kwargs) -> dict:
    """Trains ``cfg`` on ``device`` (None: the card, which must exist) for
    ``cfg.train.epochs`` epochs, or until ``max_steps`` steps, early
    stopping or a non-finite loss (``nan_abort``), checkpointing the best
    state by val loss into ``cfg.train.ckpt_dir``; then the test pass
    (``evaluate_model``). Returns its results with the epochs' ``history``
    and the ``steps`` taken; writes ``results.json`` into
    ``cfg.train.out_dir`` and the epochs' CSV to ``log_csv`` when given.
    ``build_kwargs`` go to ``build_model``.

    Across cards (``cfg.mesh``, one process per card under ``torchrun``;
    ``build_mesh``) every rank runs this loop on its rows of each global
    batch of ``cfg.data.batch_size``; the losses it decides on (plateau,
    early stop, ``nan_abort``, the best checkpoint) are the data ranks'
    means, the same on every rank, so every rank takes the same branch.
    Rank 0 alone prints, writes the checkpoints, the CSV, results.json and
    the strips; every rank returns the results."""
    mesh, device = build_mesh(cfg, device)
    lead = _lead(mesh)
    train_ds, val_ds, test_ds = build_datasets(cfg)
    train_loader = _loader(cfg, train_ds, True, device, mesh)
    val_loader = _loader(cfg, val_ds, False, device, mesh)
    test_loader = _loader(cfg, test_ds, False, device, mesh)
    for name, ld in [("train", train_loader), ("val", val_loader), ("test", test_loader)]:
        if len(ld) == 0:
            raise ValueError(f"{name} loader yields 0 batches (dataset len {len(ld.dataset)} "
                             f"< batch {cfg.data.batch_size}?)")
    steps_per_epoch = max(len(train_loader), 1)

    model = build_model(cfg, **build_kwargs)
    loss_fn = build_loss(cfg, mesh)
    tx = build_optimizer(cfg, steps_per_epoch)
    state = place_state(cfg, model, tx, init_state(cfg, model, tx, seed=cfg.train.seed,
                                                   device=device), mesh)
    # DropPath's masks, and the device-cache epoch's permutation: every rank
    # draws what the one process would.
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    train_step = make_train_step(model, loss_fn, tx, cfg)
    eval_step = make_eval_step(model, loss_fn, cfg)

    # The corpus on the device, each batch gathered there; the loader path
    # where max_steps cuts an epoch.
    use_device_cache = cfg.data.device_cache and max_steps is None
    if use_device_cache:
        def corpus(ds):
            return torch.from_numpy(np.stack([ds[i] for i in range(len(ds))])).to(device)

        train_data, val_data = corpus(train_ds), corpus(val_ds)
        # The loaders' emptiness check above leaves every split a full batch.
        n_tr_batches = len(train_ds) // cfg.data.batch_size
        run_epoch = make_epoch_runner(model, loss_fn, tx, cfg, n_tr_batches)
        run_val = make_val_epoch(model, loss_fn, cfg, len(val_ds) // cfg.data.batch_size)

    plateau = None
    if cfg.train.schedule == "plateau":
        plateau = PlateauScheduler(factor=cfg.train.plateau_factor,
                                   patience=cfg.train.plateau_patience)
    best_val, bad_epochs, start_epoch = float("inf"), 0, 0
    ckpt = None
    if cfg.train.ckpt_dir:
        ckpt = CheckpointManager(cfg.train.ckpt_dir)
        if cfg.train.resume:
            step_restored, restored = ckpt.restore_latest(state)
            if restored is not None:
                state = restored
                extra = ckpt.extra(step_restored)
                start_epoch = extra["epoch"] + 1
                train_loader.epoch = extra["loader_epoch"]
                generator.set_state(extra["generator"])
                best_val = extra["best_val"]
                if plateau is not None:
                    plateau.best, plateau.bad = extra["plateau"]
                if lead:
                    print(f"resumed from checkpoint step {step_restored} "
                          f"(epoch {extra['epoch']})")
    if plateau is not None:
        # Carried over on resume: the restored optimizer state holds it.
        plateau.scale = float(state.opt_state.scale)

    csv_rows = []
    global_step = state.step
    t_start = time.time()
    history = {"train_loss": [], "val_loss": []}

    for epoch in range(start_epoch, cfg.train.epochs):
        if use_device_cache:
            state, tr_loss = run_epoch(state, train_data, generator)
            val_loss = float(run_val(state, val_data))
            train_loss = float(tr_loss)
            global_step += n_tr_batches
        else:
            # The losses stay on the device until the epoch ends: a read per
            # step would wait for the device every step.
            ep_losses = []
            for batch in train_loader:
                state, m = train_step(state, batch, generator)
                ep_losses.append(m["loss"])
                global_step += 1
                if max_steps and global_step >= max_steps:
                    break
            train_loss = float(torch.stack(ep_losses).mean()) if ep_losses else 0.0
            v_losses = [eval_step(state, batch)[0] for batch in val_loader]
            val_loss = float(_data_mean(mesh, torch.stack(v_losses).mean())) if v_losses else 0.0

        if plateau is not None and math.isfinite(val_loss):
            scale = plateau.update(val_loss)
            state = dataclasses.replace(
                state, opt_state=dataclasses.replace(state.opt_state, scale=scale))

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        csv_rows.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
                         "time": time.time() - t_start})
        if lead:
            print(f"epoch {epoch}: train={train_loss:.5f} val={val_loss:.5f} "
                  f"({global_step} steps, {time.time() - t_start:.0f}s)")

        if cfg.train.nan_abort and not (math.isfinite(train_loss) and math.isfinite(val_loss)):
            # The parameters are dead, and NaN < best_val is False: no
            # checkpoint would ever be saved again.
            if lead:
                print(f"ABORT: non-finite loss at epoch {epoch} (train={train_loss}, "
                      f"val={val_loss}); stopping. Consider --train.grad_clip or a lower lr.")
            break

        if val_loss < best_val:
            best_val = val_loss
            bad_epochs = 0
            if ckpt is not None:
                ckpt.save(global_step, state, val_loss, extra={
                    "epoch": epoch, "loader_epoch": train_loader.epoch,
                    "generator": generator.get_state(), "best_val": best_val,
                    "plateau": None if plateau is None else [plateau.best, plateau.bad]})
        else:
            bad_epochs += 1
            if cfg.train.early_stop_patience and bad_epochs >= cfg.train.early_stop_patience:
                if lead:
                    print(f"early stop at epoch {epoch} "
                          f"(patience {cfg.train.early_stop_patience})")
                break

        if max_steps and global_step >= max_steps:
            break

    results = evaluate_model(cfg, state, eval_step, test_loader)
    results["history"] = history
    results["steps"] = global_step
    if cfg.train.out_dir and lead:
        _write_results_json(os.path.join(cfg.train.out_dir, "results.json"), results, cfg)
    if log_csv and csv_rows and lead:
        if os.path.dirname(log_csv):
            os.makedirs(os.path.dirname(log_csv), exist_ok=True)
        with open(log_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(csv_rows[0]))
            w.writeheader()
            w.writerows(csv_rows)
    return results


def evaluate_model(cfg: ExperimentConfig, state: TrainState, eval_step, test_loader) -> dict:
    """The reference's test() (train_shanghai.py:218-283): the streaming
    CSI/POD/HSS/FAR/RMSE/SSIM evaluator, per forecast frame too, the
    scatter metrics where ``scatter_eval`` (and their CSV in ``out_dir``),
    PNG strips of the first ``vis_batches`` batches' samples in
    ``out_dir``/vis, and the mean test loss. In a data-parallel run each
    rank evaluates its rows; the evaluator gathers the ranks' per-sample
    scores in the one process's order (``Evaluator(data_axis=...)``), the
    scatter metrics and the strips gather the rows, and the test loss is the
    ranks' mean: every rank returns the one process's results, and rank 0
    writes the files."""
    mesh = state.mesh
    axis = None if mesh is None else mesh.axis("data")
    lead = _lead(mesh)
    evaluator = Evaluator(seq_len=cfg.data.out_frames, value_scale=cfg.data.value_scale,
                          thresholds=tuple(cfg.data.thresholds),
                          lpips_fn=make_lpips_fn(cfg.data.lpips_weights, test_loader.device),
                          data_axis=axis)
    out_dir = cfg.train.out_dir
    if out_dir and lead:
        os.makedirs(out_dir, exist_ok=True)
    vis_dir = os.path.join(out_dir, "vis") if out_dir else None
    scatter_gts: list = []
    scatter_preds: list = []
    losses = []
    for bi, batch in enumerate(test_loader):
        loss, pred, tgt = eval_step(state, batch)
        evaluator.evaluate(tgt, pred)
        losses.append(loss)
        if axis is not None and (cfg.train.scatter_eval or (vis_dir and bi < cfg.train.vis_batches)):
            pred, tgt, batch = (gather(t.contiguous(), axis) for t in (pred, tgt, batch))
        if cfg.train.scatter_eval:
            # Every prediction and target flattened, clipped as the
            # reference's .clip(0, 1) readback (train_LAPS.py:274-331).
            scatter_preds.append(pred.clamp(0, 1).cpu().numpy())
            scatter_gts.append(tgt.clamp(0, 1).cpu().numpy())
        if vis_dir and bi < cfg.train.vis_batches and lead:
            from kmunet_tpu_torch.utils.vis import vis_res

            pred_np = pred.clamp(0, 1).cpu().numpy()
            tgt_np = tgt.clamp(0, 1).cpu().numpy()
            inp_np = batch[:, :cfg.data.in_frames].float().clamp(0, 1).cpu().numpy()
            for si in range(pred_np.shape[0]):
                vis_res(pred_np[si], tgt_np[si], inp_np[si],
                        os.path.join(vis_dir, f"batch_{bi}_sample_{si}"))
    results = evaluator.done() if losses else {}
    if losses:
        results["per_horizon"] = evaluator.per_horizon()
    if cfg.train.scatter_eval and scatter_gts:
        results["scatter"] = scatter_evaluate(
            np.concatenate(scatter_gts), np.concatenate(scatter_preds),
            thresholds=tuple(cfg.data.thresholds),
            csv_path=os.path.join(out_dir, "scatter_metrics.csv") if out_dir and lead else None)
    if losses and mesh is not None:
        losses = [float(v) for v in _data_mean(mesh, torch.stack(losses))]
    results["test_loss"] = sum(float(v) for v in losses) / max(len(losses), 1)
    return results


def evaluate_checkpoint(cfg: ExperimentConfig, ckpt_dir: str, which: str = "best", device=None,
                        **build_kwargs) -> dict:
    """Restores the ``which`` checkpoint of ``ckpt_dir`` ('best' by val
    loss, the reference's reload before test, or 'latest') on ``device``
    (None: the card) and runs only the test pass; ``build_kwargs`` go to
    ``build_model``. Across cards as ``train_and_evaluate``: every rank
    restores the whole checkpoint and keeps its blocks of the sharded
    leaves; rank 0 writes results.json."""
    mesh, device = build_mesh(cfg, device)
    _, _, test_ds = build_datasets(cfg)
    test_loader = _loader(cfg, test_ds, False, device, mesh)
    if len(test_loader) == 0:
        raise ValueError(f"test loader yields 0 batches (dataset len {len(test_ds)} < batch "
                         f"{cfg.data.batch_size}?): the metrics would be empty")
    if which not in ("best", "latest"):
        raise ValueError(f"which={which!r}: expected 'best' or 'latest'")
    model = build_model(cfg, **build_kwargs)
    loss_fn = build_loss(cfg, mesh)
    tx = build_optimizer(cfg, steps_per_epoch=1)
    state = place_state(cfg, model, tx, init_state(cfg, model, tx, seed=cfg.train.seed,
                                                   device=device), mesh)
    ckpt = CheckpointManager(ckpt_dir)
    step, state = ckpt.restore_best(state) if which == "best" else ckpt.restore_latest(state)
    if state is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    results = evaluate_model(cfg, state, make_eval_step(model, loss_fn, cfg), test_loader)
    results["checkpoint_step"] = int(step)
    if cfg.train.out_dir and _lead(mesh):
        _write_results_json(os.path.join(cfg.train.out_dir, "results.json"), results, cfg)
    return results


def main(argv=None, device=None):
    """The JAX engine's command line: ``--config=synthetic|shanghai|laps``,
    ``--max_steps=N`` and dotted overrides (``parse_overrides``). ``device``
    is for a caller in Python (None: the card). Across cards::

        torchrun --nproc_per_node=N -m kmunet_tpu_torch.train.engine --config=... [--mesh.model=2 --mesh.fsdp=True]

    runs one process per card over the mesh of ``--mesh.*`` (data=-1: every
    card on the data axis); the process group it made is closed at the end."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_name = "synthetic"
    max_steps = None
    rest = []
    for a in argv:
        if a.startswith("--config="):
            config_name = a.split("=", 1)[1]
        elif a.startswith("--max_steps="):
            max_steps = int(a.split("=", 1)[1])
        else:
            rest.append(a)

    if config_name == "shanghai":
        cfg = shanghai_km_unet()
    elif config_name == "laps":
        cfg = laps_km_unet()
    else:
        cfg = shanghai_km_unet()
        cfg.data.name = "synthetic"
    parse_overrides(cfg, rest)
    joined = torch.distributed.is_initialized()
    try:
        results = train_and_evaluate(cfg, max_steps=max_steps, device=device)
    finally:
        if not joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if int(os.environ.get("RANK", 0)) == 0:
        print({k: v for k, v in results.items() if k != "history"})
    return results


if __name__ == "__main__":
    main()
