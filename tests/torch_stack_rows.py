"""ConvLSTM, TrajGRU and Mamba-UNet on sharded image rows on the CPU: the
jobs that tests/test_torch_spatial_stack.py runs in gloo ranks
(``torch_ranks.spawn``). Nothing here imports JAX.

``HALOS`` are the row halos these models add to KM_UNetV3's, each run by
``torch_rows.module_job`` sharded and whole in the same rank: strided
convs (EF's stages, and a 7-row kernel whose halo is taller than a rank's
rows), transposed convs (EF's forecaster stages, Mamba-UNet's 2x2 up),
the bridge's dilated 7x7, the causal token halo of Mamba's conv1d, the
whole ``MambaBlock`` on a rank's tokens, and TrajGRU's warp with its
coordinates built in fp32 and in bf16. The model jobs run each model's
forward, a train step and TrajGRU's loop on a data x spatial mesh.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch import configs
from kmunet_tpu_torch.models import ef, mamba_unet
from kmunet_tpu_torch.nn.mamba import MambaBlock
from kmunet_tpu_torch.ops.sample import bilinear_gather_multiview
from kmunet_tpu_torch.parallel import MeshSpec, batch_sharding, make_mesh, row_sharding
from kmunet_tpu_torch.parallel.halo import (all_gather_rows, conv2d, conv_transpose2d, halo_rows,
                                            row_axis, row_range)
from kmunet_tpu_torch.train import engine, recipes
from tests import torch_ranks, torch_rows

MODELS = ("convlstm", "trajgru", "mamba_unet")
EF_MODELS = ("convlstm", "trajgru")  # (B, S, H, W) in, rows on dim 2
FLOW_SCALE = 30.0  # TrajGRU's flow convs: flows of a few pixels, across a rank's rows


class Conv(nn.Module):
    """A strided or dilated conv through ``halo.conv2d``."""

    def __init__(self, c, f, k, s, p, d=1):
        super().__init__()
        self.conv = nn.Conv2d(c, f, k, s, p, d)

    def forward(self, x):
        return conv2d(self.conv, x)


class Transposed(nn.Module):
    """A transposed conv through ``halo.conv_transpose2d``."""

    def __init__(self, c, f, k, s, p):
        super().__init__()
        self.conv = ef.conv_t(c, f, k, s, p)

    def forward(self, x):
        return conv_transpose2d(self.conv, x)


class Bridge(nn.Module):
    """Mamba-UNet's ``SpatialAttBridge`` on one map: the channel mean and
    max, the dilated 7x7 (dilation 3, padding 9), the sigmoid."""

    def __init__(self):
        super().__init__()
        self.satt = mamba_unet.SpatialAttBridge()

    def forward(self, x):
        return self.satt([x])[0]


class CausalTokens(nn.Module):
    """Mamba's causal depthwise conv1d over (B, L, D) tokens: the d_conv - 1
    tokens before them from ``halo_rows`` on the token axis."""

    def __init__(self, d, d_conv=4):
        super().__init__()
        self.d_conv = d_conv
        self.weight = nn.Parameter(torch.randn(d, 1, d_conv))
        self.bias = nn.Parameter(torch.randn(d))

    def forward(self, x):
        x = halo_rows(x.transpose(1, 2), row_axis(), self.d_conv - 1, 0)
        return F.conv1d(x, self.weight, self.bias, groups=x.shape[1]).transpose(1, 2)


class Warp(nn.Module):
    """TrajGRU's warp of an NCHW state (the input's first ``c`` channels) at
    ``views`` flow fields (the last 2 * views channels, times ``scale``):
    the coordinates built in ``dtype`` from the global row index, the
    gather in fp32 from the whole state -> (B, views * c, H, W)."""

    def __init__(self, c, views, dtype, scale=2.5):
        super().__init__()
        self.c, self.views, self.dtype, self.scale = c, views, dtype, scale
        self.gain = nn.Parameter(torch.ones(()))

    def forward(self, x):
        h, flows = x[:, :self.c] * self.gain, x[:, self.c:] * self.scale
        axis = row_axis()
        vx, vy = ef.warp_coordinates(flows.to(self.dtype), self.views, self.dtype,
                                     row_range(axis, h.shape[2])[0])
        out = bilinear_gather_multiview(all_gather_rows(h.permute(0, 2, 3, 1), axis, dim=1)
                                        .contiguous(), vx.float().contiguous(),
                                        vy.float().contiguous(), padding_mode="zeros")
        return out.permute(0, 3, 1, 2)


# name: (make, input shape, row dim, dtype, train mode), as torch_rows.MODULES;
# 16 or 8 rows: 8 or 4 (sp2) and 4 or 2 (sp4) a rank; 4 rows: 1 a rank at sp4.
HALOS = {
    "stride_k6s4": (lambda: Conv(1, 3, 6, 4, 1), (2, 1, 16, 13), 2, torch.float32, False),
    "stride_k4s4": (lambda: Conv(3, 4, 4, 4, 1), (2, 3, 16, 12), 2, torch.float32, False),
    "stride_k3s2": (lambda: Conv(3, 4, 3, 2, 1), (2, 3, 8, 7), 2, torch.float32, False),
    "stride_k7s2_tall": (lambda: Conv(2, 3, 7, 2, 3), (2, 2, 8, 9), 2, torch.float32, False),
    "transposed_k4s2": (lambda: Transposed(3, 4, 4, 2, 1), (2, 3, 4, 5), 2, torch.float32,
                        False),
    "transposed_k6s4": (lambda: Transposed(3, 2, 6, 4, 1), (2, 3, 4, 5), 2, torch.float32,
                        False),
    "transposed_k2s2": (lambda: Transposed(3, 3, 2, 2, 0), (2, 3, 4, 5), 2, torch.float32,
                        False),
    "dilated": (lambda: Conv(3, 2, 7, 1, 9, 3), (2, 3, 16, 11), 2, torch.float32, False),
    "bridge_dilated_tall": (Bridge, (2, 5, 4, 6), 2, torch.float32, False),
    "causal_tokens": (lambda: CausalTokens(6), (2, 8, 6), 1, torch.float32, False),
    "mamba_block": (lambda: MambaBlock(8), (2, 8, 8), 1, torch.float32, False),
    "warp_fp32": (lambda: Warp(4, 3, torch.float32), (2, 10, 32, 9), 2, torch.float32, False),
    "warp_bf16": (lambda: Warp(4, 3, torch.bfloat16), (2, 10, 32, 9), 2, torch.float32, False),
}


def stack_config(name, size, data=-1, spatial=1):
    """The (``name``, "pic") recipe on synthetic data at ``size``^2 (64: B=2,
    the dp2 x sp2 case's; 128, which sp4 needs: B=1), 3 -> 2 frames, fp32,
    on a ``data`` x ``spatial`` mesh."""
    cfg = recipes.apply_recipe(configs.shanghai_km_unet(), name, "pic")
    cfg.data.name = "synthetic"
    cfg.data.img_size, cfg.data.batch_size = size, 2 if size == 64 else 1
    cfg.data.seq_len, cfg.data.in_frames, cfg.data.out_frames = 5, 3, 2
    cfg.model.num_classes = 2
    cfg.train.compute_dtype = "float32"
    cfg.mesh.data, cfg.mesh.spatial = data, spatial
    return cfg


def stack_batch(cfg) -> torch.Tensor:
    """The seeded global batch of ``cfg``: frames in [0, 1), the EF models'
    targets in [0, 50), across weighted_mse_mae's thresholds."""
    d = cfg.data
    batch = np.random.default_rng(7).random((d.batch_size, d.seq_len, d.img_size, d.img_size),
                                            dtype=np.float32)
    if cfg.model.name in EF_MODELS:
        batch[:, d.in_frames:] *= 50.0
    return torch.from_numpy(batch)


@torch.no_grad()
def scale_flows(model):
    """TrajGRU's flow convs times FLOW_SCALE (the seeded init's flows stay
    within a tenth of a pixel); nothing on the other models."""
    for m in model.modules():
        if isinstance(m, ef.TrajGRUCell):
            m.flows_conv.weight.mul_(FLOW_SCALE)
            m.flows_conv.bias.mul_(FLOW_SCALE)


def one_step(cfg, mesh=None) -> dict:
    """One step of ``cfg`` on ``stack_batch`` (this rank's rows and block
    of image rows under a ``mesh``) from seeded weights (``scale_flows``):
    the loss, the grad norm, the gradients the optimizer took and the
    parameters after it."""
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, seed=0, device="cpu", mesh=mesh)
    scale_flows(model)
    step = engine.make_train_step(model, engine.build_loss(cfg, mesh), tx, cfg)
    batch = stack_batch(cfg)
    if mesh is not None:
        batch = row_sharding(mesh, batch_sharding(mesh, batch))
    seen = []
    update = tx.update
    tx.update = lambda grads, *a, **k: seen.append([g.clone() for g in grads]) or update(
        grads, *a, **k)
    state, m = step(state, batch, None)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": dict(zip(state.params, seen[0])),
            "params": {k: p.detach().clone() for k, p in state.params.items()}}


def _updated(cfg, grads) -> dict:
    """The parameters after the recipe's optimizer takes ``grads`` from the
    seeded weights (``one_step``'s start)."""
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, seed=0, device="cpu")
    scale_flows(model)
    tx.update([grads[k].clone() for k in state.params], state.opt_state,
              list(state.params.values()))
    return {k: p.detach() for k, p in state.params.items()}


def _max(t) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def step_job(name, size, data, spatial, ref_path):
    """``one_step`` of ``stack_config(name, size)`` on its ``data`` x
    ``spatial`` mesh against the one process's (saved in ``ref_path``),
    reckoned in the rank (the leaves are too many to send back whole): the
    loss, the grad norm, and per leaf the gradient's largest distance from
    the one process's and that one's largest |value|, the parameters' after
    the step past what the optimizer makes of the two gradients from the
    same weights (``_updated``), and the one process's largest |value|;
    whether every rank's parameters equal rank 0's."""
    got = one_step(stack_config(name, size, data, spatial), make_mesh(MeshSpec(data, spatial, 1)))
    ref = torch.load(ref_path)
    plain = stack_config(name, size)
    mine, theirs = _updated(plain, got["grads"]), _updated(plain, ref["grads"])
    alike = True
    for p in got["params"].values():
        first = p.clone()
        torch.distributed.broadcast(first, 0)
        alike = alike and torch.equal(first, p)
    leaves = {}
    for k, want in ref["grads"].items():
        past = (got["params"][k] - ref["params"][k]).abs() - (mine[k] - theirs[k]).abs()
        leaves[k] = {"grad_err": _max(got["grads"][k] - want), "grad_max": _max(want),
                     "state_err": _max(past.clamp_min(0)), "param_max": _max(ref["params"][k])}
    return {"loss": got["loss"], "grad_norm": got["grad_norm"], "alike": alike,
            "leaves": leaves, "same_leaves": set(got["grads"]) == set(ref["grads"])}


def forward_job(name, state_path, x):
    """The model ``name`` (``stack_config``'s, 2 frames out) in eval mode on
    a 1 x world mesh with the weights in ``state_path``: its output rows on
    this rank's rows of ``x`` (numpy; (B, S, H, W) for the EF models,
    (B, H, W, S) for Mamba-UNet)."""
    cfg = stack_config(name, x.shape[2])
    world = torch.distributed.get_world_size()
    mesh = make_mesh(MeshSpec(1, world, 1))
    model = engine.build_model(cfg)
    model.load_state_dict(torch.load(state_path))
    model.row_axis = mesh.axis("spatial")
    dim = 2 if name in EF_MODELS else 1
    with torch.no_grad():
        return model.eval()(row_sharding(mesh, torch.from_numpy(x), dim))


def trainer_config(tmp, spatial):
    """TrajGRU's loop at ``stack_config``'s 64^2: SGD, one epoch of 2 steps,
    val and test one batch each, checkpoints and results.json under
    ``tmp``."""
    cfg = stack_config("trajgru", 64, spatial=spatial)
    cfg.data.synthetic_length = 4
    cfg.data.num_workers = 1
    cfg.train.optimizer = "sgd"
    cfg.train.epochs = 1
    cfg.train.vis_batches = 0
    cfg.train.ckpt_dir = str(pathlib.Path(tmp) / "ckpt")
    cfg.train.out_dir = str(pathlib.Path(tmp) / "out")
    return cfg


def trainer_job(tmp, spatial):
    """``torch_ranks.trainer_job``'s loop (its results and the frames each
    rank scored) of ``trainer_config(tmp, spatial)``."""
    original = torch_ranks.trainer_config
    torch_ranks.trainer_config = lambda t, cache: trainer_config(t, spatial)
    try:
        return torch_ranks.trainer_job(tmp, False)
    finally:
        torch_ranks.trainer_config = original


def refusals_job():
    """On 2 ranks: (type name, message) of what each case raises, or None:
    ``build_mesh`` for the three models at 64^2 (accepted) and at 96^2
    (not a multiple of 32 x 2), Mamba-UNet's ``seq_mesh`` on sharded rows,
    and ``init_state`` of a baseline on a 1 x 2 mesh."""
    def outcome(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__, str(e)
        return None

    out = {}
    for name in MODELS:
        out[f"accepted_{name}"] = outcome(lambda: engine.build_mesh(stack_config(name, 64, 1, 2),
                                                                    "cpu"))
        uneven = stack_config(name, 64, 1, 2)
        uneven.data.img_size = 96
        out[f"uneven_{name}"] = outcome(lambda: engine.build_mesh(uneven, "cpu"))
    mesh = make_mesh(MeshSpec(1, 2, 1))
    model = mamba_unet.Mamba_UNet(predicted_frames=2, input_frames=3, seq_mesh=mesh)
    model.row_axis = mesh.axis("spatial")
    out["seq_mesh"] = outcome(lambda: model(torch.zeros(1, 32, 64, 3)))
    baseline = stack_config("mamba_unet", 64, 1, 2)
    baseline.model.name = "smaat_unet"
    tx = engine.build_optimizer(baseline, steps_per_epoch=1)
    out["baseline"] = outcome(lambda: engine.init_state(baseline, engine.build_model(baseline), tx,
                                                        device="cpu", mesh=mesh))
    return out


def halo_job(spec):
    """``torch_rows.module_job`` of every ``HALOS`` entry on ``spec``'s mesh."""
    return torch_rows.module_job(spec, table=HALOS)
