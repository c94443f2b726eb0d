"""KM_UNetV3 on sharded image rows on the CPU: the jobs that
tests/test_torch_spatial.py runs in gloo ranks (``torch_ranks.spawn``).
Nothing here imports JAX.

``module_job`` runs each module of the model on this rank's block of rows
(inside ``halo.sharded_rows``) and, in the same rank, whole on the global
input: its output rows, its input's gradient rows and its parameters'
gradients summed over the ranks, beside the whole module's. ``step_job``
and ``trainer_job`` are ``torch_ranks``'s on a data x spatial mesh.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from kmunet_tpu_torch.models.km_unet import (EnhancedViMBlock, StableHybridKANConv,
                                             KM_UNetV3)
from kmunet_tpu_torch.nn.attention import LocalContrastAttention, MultiScaleFusion
from kmunet_tpu_torch.nn.dagem import DAGEM
from kmunet_tpu_torch.nn.init import init_module_
from kmunet_tpu_torch.nn.layers import ConvBNAct, set_data_axis
from kmunet_tpu_torch.nn.resample import DeformConv2d, DySample
from kmunet_tpu_torch.nn.ssd import EfficientViMBlock
from kmunet_tpu_torch.nn.wavelet import IntelligentWaveletPooling
from kmunet_tpu_torch.ops.sample import resize_bilinear
from kmunet_tpu_torch.parallel import MeshSpec, make_mesh, row_sharding
from kmunet_tpu_torch.parallel.collectives import all_reduce_
from kmunet_tpu_torch.parallel.halo import conv2d, halo_rows, row_axis, sharded_rows
from kmunet_tpu_torch.parallel.mesh import IMAGE
from kmunet_tpu_torch.train import engine
from tests import torch_ranks


class Conv(nn.Module):
    """A stride-1 conv through ``halo.conv2d``."""

    def __init__(self, c, f, k):
        super().__init__()
        self.conv = nn.Conv2d(c, f, k, padding=k // 2)

    def forward(self, x):
        return conv2d(self.conv, x)


class Halo(nn.Module):
    """A 4-row stencil over ``halo_rows``' 2 rows above and 1 below, in ``mode``."""

    def __init__(self, mode):
        super().__init__()
        self.mode = mode
        self.w = nn.Parameter(torch.tensor([1.0, -2.0, 3.0, 0.5]))

    def forward(self, x):
        p = halo_rows(x, row_axis(), 2, 1, mode=self.mode)
        h = x.shape[2]
        return sum(self.w[i] * p[:, :, i:i + h] for i in range(4)) * x


class Resize(nn.Module):
    """``resize_bilinear`` to ``factor`` x the global size, align_corners."""

    def __init__(self, factor):
        super().__init__()
        self.factor = factor
        self.scale = nn.Parameter(torch.ones(()))

    def forward(self, x):
        axis = row_axis()
        H = x.shape[2] * (1 if axis is None else axis.size)
        size = (int(H * self.factor), int(x.shape[3] * self.factor))
        return resize_bilinear(x * self.scale, size, align_corners=True)


class Fusion(nn.Module):
    """MultiScaleFusion on three maps cut from one input's channels."""

    def __init__(self):
        super().__init__()
        self.fusion = MultiScaleFusion((4, 8, 8))

    def forward(self, x):
        return self.fusion([x[:, :4], x[:, 4:12], x[:, 12:20]])


class Deform(nn.Module):
    """DeformConv2d on NHWC x, its offsets the input's last 18 channels
    times 3 (taps landing up to several rows away)."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.conv = DeformConv2d(c, c)

    def forward(self, x):
        return self.conv(x[..., :self.c].contiguous(), 3.0 * x[..., self.c:])


def _dysample(window):
    def make():
        m = DySample(8, window=window)
        with torch.no_grad():
            m.offset.weight.mul_(800.0)  # offsets of about a pixel: taps across row blocks
        return m
    return make


# name: (make, input shape, row dim, dtype, train mode)
MODULES = {
    "conv3": (lambda: Conv(4, 6, 3), (2, 4, 8, 8), 2, torch.float32, False),
    "conv7": (lambda: Conv(4, 4, 7), (2, 4, 8, 8), 2, torch.float32, False),
    "halo_zeros": (lambda: Halo("zeros"), (2, 3, 8, 5), 2, torch.float32, False),
    "halo_wrap": (lambda: Halo("wrap"), (2, 3, 8, 5), 2, torch.float32, False),
    "halo_replicate": (lambda: Halo("replicate"), (2, 3, 8, 5), 2, torch.float32, False),
    "dwt_iwp": (lambda: IntelligentWaveletPooling(4), (2, 4, 16, 16), 2, torch.float32, False),
    "kan_group_norm": (lambda: StableHybridKANConv(4, 8), (2, 4, 8, 8), 2, torch.float32,
                       False),
    "batch_norm": (lambda: ConvBNAct(4, 4, (3, 3), groups=4), (2, 4, 8, 8), 2, torch.float64,
                   True),
    "hsmssd_block": (lambda: EfficientViMBlock(8, state_dim=8), (2, 8, 8, 8), 2, torch.float64,
                     True),
    "enhanced_vim": (lambda: EnhancedViMBlock(8, drop_path=0.0), (2, 8, 8, 8), 2,
                     torch.float64, True),
    "lca": (lambda: LocalContrastAttention(8), (2, 8, 8, 8), 2, torch.float32, False),
    "fusion": (Fusion, (2, 20, 8, 8), 2, torch.float32, False),
    "resize_down": (lambda: Resize(0.5), (2, 3, 16, 16), 2, torch.float32, False),
    "resize_up": (lambda: Resize(2.0), (2, 3, 8, 8), 2, torch.float32, False),
    "dysample_window": (_dysample(True), (2, 8, 8, 8), 2, torch.float32, False),
    "dysample_exact": (_dysample(False), (2, 8, 8, 8), 2, torch.float32, False),
    "deform_conv": (lambda: Deform(8), (2, 8, 8, 26), 1, torch.float32, False),
    "dagem": (lambda: DAGEM(8), (2, 8, 8, 8), 2, torch.float64, True),
}


def _run(module, x, g_of):
    """(out, [dx, *dparams]) of sum(module(x) * g_of(out))."""
    x = x.clone().requires_grad_()
    out = module(x)
    g = g_of(out)
    params = list(module.parameters())
    grads = torch.autograd.grad((out * g).sum(), [x, *params], allow_unused=True,
                                materialize_grads=True)
    return out.detach(), list(grads)


def module_job(spec, names=None, table=None):
    """Each of ``table`` (default ``MODULES``; or its ``names``) on the mesh
    of ``spec``: {name: {"out", "dx", "params", "buffers"}: pairs (this
    rank's, the whole module's rows or leaves)}."""
    table = MODULES if table is None else table
    mesh = make_mesh(MeshSpec(*spec))
    rows = mesh.axis("spatial")
    out = {}
    for name in names or table:
        make, shape, dim, dtype, train = table[name]
        torch.manual_seed(0)
        whole = make()
        init_module_(whole, torch.Generator().manual_seed(1))
        whole.to(dtype).train(train)
        part = copy.deepcopy(whole)
        set_data_axis(part, None, mesh.axis(IMAGE))
        x = torch.from_numpy(np.random.default_rng(2).normal(size=shape)).to(dtype)
        seen = {}

        def upstream(o):
            if "g" not in seen:
                seen["g"] = torch.from_numpy(np.random.default_rng(3).normal(
                    size=o.shape)).to(dtype)
            return seen["g"]

        want, want_grads = _run(whole, x, upstream)
        with sharded_rows(rows):
            got, got_grads = _run(part, row_sharding(mesh, x, dim),
                                  lambda o: row_sharding(mesh, seen["g"], dim))
        for g in got_grads[1:]:
            all_reduce_(g, rows)
        out[name] = {
            "out": (got, row_sharding(mesh, want, dim)),
            "dx": (got_grads[0], row_sharding(mesh, want_grads[0], dim)),
            "params": [(a, b) for a, b in zip(got_grads[1:], want_grads[1:])],
            "buffers": [(a.clone(), b.clone()) for a, b in zip(part.buffers(), whole.buffers())
                        if a.is_floating_point()],
        }
    return out


def model_job(spec):
    """KM_UNetV3 (SH window, SH exact, LAPS) at 32^2, train mode, drop
    path 0, float64, on this rank's rows: as ``module_job``'s pairs."""
    mesh = make_mesh(MeshSpec(*spec))
    rows = mesh.axis("spatial")
    out = {}
    for name, kw in (("sh_window", {}), ("sh_exact", {"dysample_window": False}),
                     ("laps", {"variant": "laps", "num_classes": 3})):
        whole = KM_UNetV3(**{"num_classes": 4, "drop_path": 0.0, **kw})
        init_module_(whole, torch.Generator().manual_seed(1))
        whole.to(torch.float64).train()
        part = copy.deepcopy(whole)
        set_data_axis(part, None, mesh.axis(IMAGE))
        x = torch.from_numpy(np.random.default_rng(4).random((2, 32, 32, 5)))
        seen = {}

        def upstream(o):
            seen.setdefault("g", torch.from_numpy(np.random.default_rng(5).normal(
                size=o.shape)))
            return seen["g"]

        want, want_grads = _run(whole, x, upstream)
        part.row_axis = rows
        got, got_grads = _run(part, row_sharding(mesh, x, 1),
                              lambda o: row_sharding(mesh, seen["g"], 1))
        for g in got_grads[1:]:
            all_reduce_(g, rows)
        out[name] = {"out": (got, row_sharding(mesh, want, 1)),
                     "dx": (got_grads[0], row_sharding(mesh, want_grads[0], 1)),
                     "params": [(a, b) for a, b in zip(got_grads[1:], want_grads[1:])],
                     "buffers": [(a.clone(), b.clone()) for a, b in
                                 zip(part.buffers(), whole.buffers()) if a.is_floating_point()]}
    return out


# The KAN regularizer's gradient is then about the loss's on the spline
# weights (1e-4 at the small config): a factor of the shard count on it
# shows in every KAN leaf.
KAN_REG_WEIGHT = 1e-3


def step_config(variant="sh", data=-1, spatial=1):
    """The small config (32^2, B=8, 9 frames -> 4) of ``variant``: "sh", the
    LAPS variant ("laps", 9 frames -> 3), or SH with the KAN regularizer
    ("kan_reg", ``KAN_REG_WEIGHT``)."""
    cfg = torch_ranks.small_config(data, spatial=spatial)
    if variant == "laps":
        cfg.model.variant, cfg.model.num_classes, cfg.data.out_frames = "laps", 3, 3
    elif variant == "kan_reg":
        cfg.train.kan_reg_weight = KAN_REG_WEIGHT
    return cfg


def step_job(data, spatial, ckpt_dir, variant="sh"):
    """``torch_ranks.run_steps`` on the data x spatial mesh of
    ``step_config(variant)``, each rank on its rows and its block of image
    rows; step 2 from the one process's checkpoint."""
    cfg = step_config(variant, data, spatial)
    mesh = make_mesh(MeshSpec(cfg.mesh.data, cfg.mesh.spatial, cfg.mesh.model))
    return torch_ranks.run_steps(cfg, ckpt_dir, False, mesh)


def jax_start_step_job(initial_path, batch):
    """One step of tests/test_torch_train.py's config (B=2, no stochastic
    depth) on a 1 x 2 mesh, each rank on its 16 of the 32 image rows, from
    the state_dict in ``initial_path``: the loss and grad norm, the
    gradients the optimizer took and the state_dict after the step."""
    cfg = torch_ranks.small_config(1, spatial=2)
    cfg.data.batch_size = 2
    cfg.model.extra["drop_path"] = 0.0
    mesh = make_mesh(MeshSpec(1, 2, 1))
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, device="cpu", mesh=mesh)
    model.load_state_dict(torch.load(initial_path))
    seen = []
    update = tx.update
    tx.update = lambda grads, *a, **k: seen.append([g.clone() for g in grads]) or update(
        grads, *a, **k)
    step = engine.make_train_step(model, engine.build_loss(cfg, mesh), tx, cfg)
    state, m = step(state, row_sharding(mesh, batch), None)
    return {"metrics": (float(m["loss"]), float(m["grad_norm"])),
            "grads": dict(zip(state.params, seen[0])),
            "after": {k: v.clone() for k, v in model.state_dict().items()}}


def trainer_job(tmp, spatial, device_cache):
    """``torch_ranks.trainer_job``'s loop on a 1 x ``spatial`` mesh."""
    original = torch_ranks.small_config
    torch_ranks.small_config = lambda *a, **k: original(*a, **{**k, "spatial": spatial})
    try:
        return torch_ranks.trainer_job(tmp, device_cache)
    finally:
        torch_ranks.small_config = original


def refusals_job(tmp):
    """What ``build_mesh`` and the engine raise on 2 ranks: (type name,
    message) of each refused case; the K1-K3 cases from
    ``train_and_evaluate``, whose model refuses in its first forward."""
    def outcome(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__, str(e)
        return None

    out = {}
    cfg = torch_ranks.small_config(1, spatial=2)
    out["spatial_x_model"] = outcome(lambda: make_mesh(MeshSpec(1, 2, 2), world=4))
    other = torch_ranks.small_config(1, spatial=2)
    other.model.name = "smaat_unet"
    out["other_model"] = outcome(lambda: engine.build_mesh(other, "cpu"))
    loop = torch_ranks.trainer_config(tmp, False)
    loop.mesh.spatial, loop.data.num_workers = 2, 0
    out["kan_fused"] = outcome(lambda: engine.train_and_evaluate(loop, device="cpu",
                                                                 kan_fused=True))
    out["ssd_mixer"] = outcome(lambda: engine.train_and_evaluate(loop, device="cpu",
                                                                 ssd_mixer="fused"))
    uneven = torch_ranks.small_config(1, spatial=2)
    uneven.data.img_size = 40
    out["uneven_rows"] = outcome(lambda: engine.build_mesh(uneven, "cpu"))
    fused = engine.build_model(cfg, kan_fused=True)
    fused.row_axis = make_mesh(MeshSpec(1, 2, 1)).axis("spatial")
    frames = torch.zeros(1, 16, 32, 5)
    out["k1_forward"] = outcome(lambda: fused.eval()(frames))
    return out
