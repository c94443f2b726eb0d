"""Several ranks of the port on the CPU: ``spawn`` runs a function in gloo
processes (one torch thread each, a ``file://`` store under the test's
``tmp_path``, a deadline), and the functions the port's multi-rank tests
run in them. Nothing here imports JAX: the ranks start in seconds.

The step cases run the small config of tests/test_sharding_parity.py (32^2,
B=8, 9 frames -> 4, fp32, drop path 0.1) for two steps on one seeded
global batch, each rank on its rows, step 2 from the state that a run of
one process wrote after step 1 (``CheckpointManager``: every rank restores
it and keeps its blocks), with that run's generator state.
"""

from __future__ import annotations

import pathlib
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kmunet_tpu_torch import configs
from kmunet_tpu_torch.parallel import MeshSpec, batch_sharding, make_mesh
from kmunet_tpu_torch.train import engine
from kmunet_tpu_torch.train.checkpoint import CheckpointManager

DROPOUT_SEED = 3


def _entry(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, *args), out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` gloo processes; their results,
    by rank. A rank that raises fails the call with its traceback; ranks
    still running at the deadline are killed and the call raises."""
    out = pathlib.Path(tmp_path) / f"ranks-{uuid.uuid4().hex[:8]}"
    out.mkdir()
    ctx = mp.start_processes(_entry, args=(fn, world, str(out / "store"), out, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {timeout} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def small_config(data: int = -1, model: int = 1, fsdp: bool = False):
    """The SH recipe at tests/test_sharding_parity.py's small config."""
    cfg = configs.shanghai_km_unet()
    cfg.data.name = "synthetic"
    cfg.data.img_size, cfg.data.batch_size = 32, 8
    cfg.data.seq_len, cfg.data.out_frames = 9, 4
    cfg.model.num_classes = 4
    cfg.model.extra["drop_path"] = 0.1
    cfg.train.compute_dtype = "float32"
    cfg.mesh.data, cfg.mesh.model, cfg.mesh.fsdp = data, model, fsdp
    return cfg


def global_batch(cfg) -> torch.Tensor:
    d = cfg.data
    return torch.from_numpy(np.random.default_rng(7).random(
        (d.batch_size, d.seq_len, d.img_size, d.img_size), dtype=np.float32))


def run_steps(cfg, ckpt_dir, write: bool, mesh=None) -> dict:
    """Two steps of ``cfg`` on ``global_batch`` (this rank's rows under a
    ``mesh``) from seeded weights; step 2 from the checkpoint in
    ``ckpt_dir``, which ``write`` (a run of one process) writes after step 1
    with its generator's state. Per step the loss, the grad norm, the
    gradients the optimizer took, the parameters and BatchNorm buffers
    after it (this rank's blocks of the sharded leaves)."""
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=10)
    state = engine.init_state(cfg, model, tx, seed=0, device="cpu", mesh=mesh)
    step = engine.make_train_step(model, engine.build_loss(cfg, mesh), tx, cfg)
    batch = global_batch(cfg) if mesh is None else batch_sharding(mesh, global_batch(cfg))
    gen = torch.Generator().manual_seed(DROPOUT_SEED)
    manager = CheckpointManager(ckpt_dir)
    seen = []
    update = tx.update
    tx.update = lambda grads, *a, **k: seen.append([g.clone() for g in grads]) or update(
        grads, *a, **k)
    steps = []
    for i in range(2):
        if i == 1 and write:
            manager.save(1, state, 0.0, extra={"generator": gen.get_state()})
        elif i == 1:
            _, state = manager.restore_latest(state)
            gen.set_state(manager.extra(1)["generator"])
        state, m = step(state, batch, gen)
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "grads": dict(zip(state.params, seen[-1])),
                      "params": {k: p.detach().clone() for k, p in state.params.items()},
                      "stats": {k: b.clone() for k, b in state.batch_stats.items()}})
    return {"shards": dict(state.shards), "steps": steps,
            "coords": None if mesh is None else dict(mesh.coords),
            "shape": None if mesh is None else dict(mesh.shape)}


def run_jobs(rank, world, jobs):
    """Each ``(fn, args)`` of ``jobs`` in turn: their results, in order (one
    spawn runs every case of a world size)."""
    return [fn(*args) for fn, args in jobs]


def step_job(data, model, fsdp, ckpt_dir, fsdp_ckpt_dir):
    """``run_steps`` on the mesh of ``small_config(data, model, fsdp)``; an
    FSDP case also restores the one process's checkpoint after step 1 into a
    fresh sharded state (``restored``: its blocks) and saves that state into
    ``fsdp_ckpt_dir`` (the whole leaves, rank 0 writing)."""
    cfg = small_config(data, model, fsdp)
    mesh = make_mesh(MeshSpec(cfg.mesh.data, cfg.mesh.spatial, cfg.mesh.model))
    res = run_steps(cfg, ckpt_dir, False, mesh)
    if fsdp:
        tx = engine.build_optimizer(cfg, steps_per_epoch=10)
        state = engine.init_state(cfg, engine.build_model(cfg), tx, seed=0, device="cpu",
                                  mesh=mesh)
        _, state = CheckpointManager(ckpt_dir).restore_latest(state)
        CheckpointManager(fsdp_ckpt_dir).save(1, state, 0.0)
        res["restored"] = {k: p.detach().clone() for k, p in state.params.items()}
    return res


def trainer_config(tmp, device_cache: bool):
    """The small config's loop: SGD, 2 epochs of 1 step, val and test one
    batch each, checkpoints and results.json under ``tmp``."""
    cfg = small_config()
    cfg.data.synthetic_length = 8
    cfg.data.num_workers = 2
    cfg.data.device_cache = device_cache
    cfg.train.optimizer = "sgd"
    cfg.train.epochs = 2
    cfg.train.vis_batches = 0
    cfg.train.ckpt_dir = str(pathlib.Path(tmp) / "ckpt")
    cfg.train.out_dir = str(pathlib.Path(tmp) / "out")
    return cfg


def trainer_job(tmp, device_cache: bool) -> dict:
    """``engine.train_and_evaluate`` of ``trainer_config``: its results, and
    the (target, prediction) rows of each test batch this rank scored."""
    from kmunet_tpu_torch.metrics import Evaluator

    seen = []

    class Recording(Evaluator):
        def evaluate(self, true_batch, pred_batch):
            seen.append((true_batch.clone(), pred_batch.clone()))
            return super().evaluate(true_batch, pred_batch)

    engine.Evaluator = Recording
    try:
        results = engine.train_and_evaluate(trainer_config(tmp, device_cache), device="cpu")
    finally:
        engine.Evaluator = Evaluator
    return {"results": results, "scored": seen}


def mesh_job(specs):
    """``make_mesh`` of each spec: its shape, this rank's coordinates and
    ranks, and the size and index of each axis and of the replica axis."""
    out = {}
    for spec in specs:
        mesh = make_mesh(MeshSpec(*spec))
        out[spec] = {"shape": mesh.shape, "coords": mesh.coords, "ranks": mesh.ranks.tolist(),
                     "axes": {name: (mesh.axis(name).size, mesh.axis(name).index)
                              for name in ("data", "spatial", "model", ("data", "model"))}}
    return out


def refusals_job(spatial_with_model):
    """What a rank raises for a spec JAX refuses, and for a CUDA device on
    this gloo group."""
    out = {}
    try:
        make_mesh(MeshSpec(*spatial_with_model))
    except ValueError as e:
        out["mesh"] = str(e)
    from kmunet_tpu_torch.parallel import init_distributed

    try:
        init_distributed("cuda")
    except RuntimeError as e:
        out["cuda_on_gloo"] = str(e)
    return out


def scan_inputs(shape, seed=0):
    """x, dt, A, B, C, D of the selective scan at (B, L, D, N), numpy fp32
    (tests/test_scan_sharded.py's distributions), and an upstream gradient."""
    Bsz, L, D, N = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Bsz, L, D)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bsz, L, D)).astype(np.float32),
            -rng.uniform(0.5, 3.0, (D, N)).astype(np.float32),
            rng.normal(size=(Bsz, L, N)).astype(np.float32),
            rng.normal(size=(Bsz, L, N)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32),
            rng.normal(size=(Bsz, L, D)).astype(np.float32))


def scan_job(spec, shapes):
    """``selective_scan_sharded`` over the mesh of ``spec`` ('spatial' the
    scan's axis, the batch cut over 'data' as the caller's rows): per shape,
    y and the gradients of sum(y * g) to the six inputs, this rank's rows."""
    from kmunet_tpu_torch.ops.scan import selective_scan_sharded

    mesh = make_mesh(MeshSpec(*spec))
    out = {}
    for shape in shapes:
        *args, g = (torch.from_numpy(a) for a in scan_inputs(shape))
        args = [batch_sharding(mesh, a) if a.dim() == 3 else a for a in args]
        args = [a.clone().requires_grad_() for a in args]
        y = selective_scan_sharded(*args, mesh, axis="spatial", batch_axis="data")
        grads = torch.autograd.grad((y * batch_sharding(mesh, g)).sum(), args)
        out[shape] = [y.detach()] + [t for t in grads]
    return out


def mamba_job(spec, x):
    """``Mamba_UNet(seq_mesh=...)`` of the mesh of ``spec`` (seeded weights,
    no bridge, 3 frames out) on this rank's rows of ``x``."""
    from kmunet_tpu_torch.models import mamba_unet, zoo

    mesh = make_mesh(MeshSpec(*spec))
    model = mamba_unet.Mamba_UNet(predicted_frames=3, bridge=False, seq_mesh=mesh)
    zoo.init_weights_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model.eval()(batch_sharding(mesh, torch.from_numpy(x)))
