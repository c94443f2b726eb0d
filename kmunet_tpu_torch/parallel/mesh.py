"""The device mesh and the sharding rules (port of
``kmunet_tpu/parallel/mesh.py``), one process per card.

The JAX package runs one process over every device and lets GSPMD insert
the collectives. The port runs one process per card (``torchrun
--nproc_per_node=N``, or ``torch.multiprocessing.spawn``), and each process
holds what JAX's sharded arrays put on its device. The mesh has JAX's axes,

    data    -- the global batch is cut into contiguous blocks of rows, one
               per data index (``batch_sharding``);
    spatial -- image rows (H); only the sequence-parallel scan
               (``ops/scan.py::selective_scan_sharded``) uses it, and the
               trainer refuses it (ROADMAP Queue 1 item 9b);
    model   -- with ``fsdp``, the larger parameters are sharded on it
               (``param_sharding_rules``); the ranks of one data index see
               the same rows;

with the ranks laid out as JAX lays out its devices: ``ranks`` is
``arange(world).reshape(data, spatial, model)``. Each axis of the mesh
(and the data x model "replica" axis, over which the trainer averages its
gradients) has a process group, made by every rank in the same order when
the mesh is made. Without ``RANK`` / ``WORLD_SIZE`` in the environment
and no process group, the run is one process of one device: the mesh is
1 x 1 x 1 and has no groups.

On the card the group is NCCL on ``cuda:LOCAL_RANK``; gloo only where the
caller asks for ``device="cpu"``. Nothing falls back from one to the other,
or from several ranks to one: a mesh the world cannot fill raises JAX's
``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from kmunet_tpu_torch.convert import flax_permutation

AXES = ("data", "spatial", "model")
REPLICA = ("data", "model")  # the ranks that hold one spatial index: the gradients' average


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axis size -1 means "absorb remaining devices"."""

    data: int = -1
    spatial: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        sizes = [self.data, self.spatial, self.model]
        free = [i for i, s in enumerate(sizes) if s == -1]
        fixed = math.prod(s for s in sizes if s != -1)
        if n_devices % fixed:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if free:
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes) != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh (or several, taken together) as this rank sees
    it: its size, this rank's index along it, and the process group of the
    ranks that differ from this one only along it (None in a run of one
    process)."""

    name: Union[str, tuple]
    size: int
    index: int
    group: Any = None


class Mesh:
    """A ('data', 'spatial', 'model') mesh of ranks: ``shape`` maps each axis
    to its size (JAX's ``mesh.shape``), ``ranks`` is the (data, spatial,
    model) array of ranks, ``rank`` this process's, ``coords`` its index
    along each axis; ``axis(name)`` gives an ``Axis`` (a name of ``AXES`` or
    a tuple of them)."""

    def __init__(self, ranks: np.ndarray, rank: int, groups: Mapping):
        self.ranks = ranks
        self.rank = rank
        self.shape = dict(zip(AXES, ranks.shape))
        self.coords = dict(zip(AXES, (int(i) for i in np.argwhere(ranks == rank)[0])))
        self._groups = dict(groups)

    def axis(self, name: Union[str, Sequence[str]]) -> Axis:
        names = (name,) if isinstance(name, str) else tuple(name)
        size = math.prod(self.shape[a] for a in names)
        index = 0
        for a in names:  # row-major over the named axes, in the mesh's order
            index = index * self.shape[a] + self.coords[a]
        return Axis(name, size, index, self._groups.get(names))


def _axis_groups(ranks: np.ndarray, names: tuple[str, ...], rank: int):
    """Makes the process groups of ``names``: one per index of the other axes,
    each over the ranks that vary along ``names`` (in row-major order).
    Every rank makes every group, in the same order; returns this rank's."""
    along = [AXES.index(a) for a in names]
    others = [i for i in range(3) if i not in along]
    moved = np.transpose(ranks, others + along).reshape(-1, math.prod(ranks.shape[i] for i in along))
    mine = None
    for members in moved:
        group = dist.new_group([int(r) for r in members])
        if rank in members:
            mine = group
    return mine


def make_mesh(spec: MeshSpec | None = None, world: Optional[int] = None,
              allow_spatial_with_model: bool = False) -> Mesh:
    """Build a ('data', 'spatial', 'model') mesh over the run's ranks
    (``world``: the process group's size, 1 without one).

    Meshes with BOTH spatial>1 and model>1 are refused by default, as the
    JAX package refuses them: its XLA SPMD partitioner (jax 0.9) silently
    doubles halo-exchange conv weight gradients in that layout. A mesh of
    another size than the run's processes raises ``ValueError``.
    """
    spec = spec or MeshSpec()
    processes = dist.get_world_size() if dist.is_initialized() else 1
    world = processes if world is None else world
    d, s, m = spec.resolve(world)
    if s > 1 and m > 1 and not allow_spatial_with_model:
        raise ValueError(
            f"mesh (data={d}, spatial={s}, model={m}): combining spatial>1 "
            "with model>1 is disabled — the XLA SPMD partitioner miscompiles "
            "halo-exchange conv weight grads (exactly 2x) in this layout. "
            "Use dp x spatial or dp x model, or pass "
            "allow_spatial_with_model=True to override."
        )
    if world != processes:
        raise ValueError(f"mesh of {world} ranks, but this run has {processes} process(es): "
                         "start one process per rank (torchrun --nproc_per_node)")
    ranks = np.arange(world).reshape(d, s, m)
    if not dist.is_initialized():
        return Mesh(ranks, 0, {})
    rank = dist.get_rank()
    groups = {}
    for names in [(a,) for a in AXES] + [REPLICA]:
        groups[names] = _axis_groups(ranks, names, rank)
    return Mesh(ranks, rank, groups)


def batch_sharding(mesh: Mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a global ``batch``: the global batch cut
    into ``data`` contiguous blocks, block i on data index i (JAX's
    ``P('data', None, ...)``). Raises if the batch does not divide."""
    ax = mesh.axis("data")
    if batch.shape[0] % ax.size:
        raise ValueError(f"global batch {batch.shape[0]} not divisible by data={ax.size}")
    rows = batch.shape[0] // ax.size
    return batch[ax.index * rows:(ax.index + 1) * rows]


def replicated(mesh: Mesh) -> None:
    """The placement of a replicated leaf: on every rank whole (no shard axis)."""
    return None


def param_sharding_rules(mesh: Mesh, params: Mapping[str, torch.Tensor], fsdp: bool = False,
                         min_size: int = 4096) -> dict[str, Optional[int]]:
    """{name: the axis its leaf is sharded on over 'model', or None}.

    The JAX rule: with ``fsdp=False`` every parameter is replicated. With
    ``fsdp=True``, a parameter with ndim >= 2 and at least ``min_size``
    elements is sharded on its largest dim when that dim is divisible by the
    'model' axis size and at least twice it; the rest stay replicated. The
    largest dim is JAX's: the first largest in the flax layout
    (``convert.flax_permutation``), so that a square kernel is cut on the
    same logical axis (the input channels of a (64, 64) Dense or a 64 -> 64
    conv) as in the JAX package.
    """
    model_size = mesh.shape["model"]

    def rule(name, p):
        if not fsdp or model_size == 1 or p.dim() < 2 or p.numel() < min_size:
            return replicated(mesh)
        perm = flax_permutation(name, p.dim()) or tuple(range(p.dim()))
        flax_dims = [p.shape[perm.index(j)] for j in range(p.dim())]
        axis = perm.index(int(np.argmax(flax_dims)))
        if p.shape[axis] % model_size == 0 and p.shape[axis] >= 2 * model_size:
            return axis
        return replicated(mesh)

    return {name: rule(name, p) for name, p in params.items()}


def shard_params(params: Mapping[str, torch.Tensor], shardings: Mapping[str, Optional[int]],
                 mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's part of each leaf: its 'model' block of a sharded leaf
    (contiguous, the block of its model index), the leaf itself otherwise."""
    ax = mesh.axis("model")
    return {name: p if shardings.get(name) is None
            else p.chunk(ax.size, dim=shardings[name])[ax.index].clone()
            for name, p in params.items()}


def init_distributed(device=None) -> torch.device:
    """This process's device, after joining the run's process group.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) it
    makes the group: NCCL on ``cuda:LOCAL_RANK`` for the card (``device``
    None or a CUDA device), gloo for ``device="cpu"``. A group the caller
    made already is kept, and must be of the device's backend. With neither,
    the run is one process and needs no group. ``device`` None means the
    card, which must exist."""
    from kmunet_tpu_torch.serve import resolve_device  # serve imports the models

    want = torch.device("cuda" if device is None else device)
    backend = "nccl" if want.type == "cuda" else "gloo"
    env = os.environ
    if not dist.is_initialized():
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return resolve_device(device)
        if want.type == "cuda":
            resolve_device(want)
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group is {dist.get_backend()}, but {want.type} "
                           f"tensors need {backend}")
    if want.type == "cuda":
        resolve_device(want)
        index = want.index if want.index is not None else int(
            env.get("LOCAL_RANK", torch.cuda.current_device()))
        torch.cuda.set_device(index)
        return torch.device("cuda", index)
    return want
