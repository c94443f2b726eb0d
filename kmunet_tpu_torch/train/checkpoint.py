"""Checkpoints of the port's train state, best by val loss (port of
``kmunet_tpu/train/checkpoint.py``).

The card has no orbax, so each checkpoint is one ``torch.save`` file,
``<directory>/<step>.pt``: the parameters and BatchNorm running buffers,
the optimizer's state (its count and slots, and the plateau's scale), the
step, the val loss, and what the epoch loop needs to go on where it
stopped (``extra``). ``checkpoints.json`` beside them maps each step to its
val loss, orbax's metrics, so that choosing among them reads no tensor.
Orbax's semantics are kept: ``best_fn = -val_loss`` with ``max_to_keep`` =
3, so the three lowest val losses are kept (among equal ones the newer);
``latest_step`` is the newest of the kept ones and ``best_step`` the best;
both restores return ``(None, None)`` on an empty directory. A save is
synchronous (orbax's ``wait`` and ``close`` have nothing to do). Every file is
written under a temporary name and renamed into place; a checkpoint is
listed once both its file and its index entry are there.

Across cards (a state with a ``mesh`` of several processes) ``save`` is a
collective: the leaves sharded over 'model' and their optimizer slots are
gathered whole, rank 0 writes the one file, and every rank waits for it.
``restore`` reads the whole state on every rank and keeps this rank's
blocks. The file is the same either way, so a checkpoint of a
data-parallel or FSDP run restores in one process, and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from kmunet_tpu_torch.parallel.collectives import gather
from kmunet_tpu_torch.train.optimizers import ChainState, OptState

INDEX = "checkpoints.json"


def _dims(state, n: int) -> list:
    """The sharded dim (or None) of each of the state's ``n`` per-parameter
    tensors (its parameters, or an optimizer slot list of their length)."""
    shards = getattr(state, "shards", {}) if state is not None else {}
    names = list(state.params) if shards else []
    return [shards.get(k) for k in names] if len(names) == n else [None] * n


def _whole(state, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """``tensors`` on the CPU, the blocks of sharded leaves gathered whole."""
    dims = _dims(state, len(tensors))
    axis = state.mesh.axis("model") if any(d is not None for d in dims) else None
    return [(t if d is None else gather(t.detach(), axis, dim=d)).detach().cpu()
            for t, d in zip(tensors, dims)]


def _opt_tree(opt_state, state=None) -> dict:
    """An ``OptState`` or ``ChainState`` as plain containers of tensors on
    the CPU, whole (``state``'s sharded slots gathered)."""
    if isinstance(opt_state, ChainState):
        return {"inner": _opt_tree(opt_state.inner, state), "scale": opt_state.scale}
    tree = {f.name: getattr(opt_state, f.name) for f in dataclasses.fields(OptState)}
    return {k: _whole(state, v) if isinstance(v, list) else v for k, v in tree.items()}


def _copy_into(dst: list[torch.Tensor], src: list[torch.Tensor], state=None) -> None:
    """Copies the whole tensors ``src`` into ``dst`` in place, this rank's
    block of a sharded leaf."""
    if len(dst) != len(src):
        raise ValueError(f"checkpoint holds {len(src)} tensors where the state has {len(dst)}")
    dims = _dims(state, len(dst))
    axis = state.mesh.axis("model") if any(d is not None for d in dims) else None
    with torch.no_grad():
        for d, s, dim in zip(dst, src, dims):
            d.copy_(s if dim is None else s.chunk(axis.size, dim=dim)[axis.index])


def _restore_opt(opt_state, tree: dict, state=None):
    """``opt_state`` with the checkpoint's values: its tensors copied in
    place, its count and scale replaced."""
    if isinstance(opt_state, ChainState):
        return ChainState(_restore_opt(opt_state.inner, tree["inner"], state), tree["scale"])
    for name in ("mu", "nu", "trace"):
        _copy_into(getattr(opt_state, name), tree[name], state)
    return dataclasses.replace(opt_state, count=tree["count"])


def _distributed(state) -> bool:
    return getattr(state, "distributed", False)


def _by_goodness(index: dict[int, float]) -> list[int]:
    """The steps of ``index`` ordered as orbax orders them, best last:
    ascending in -val_loss, then in step."""
    return [s for s, _ in sorted(index.items(), key=lambda e: (-e[1], e[0]))]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _index(self) -> dict[int, float]:
        """{step: val loss} of the checkpoints whose files are there."""
        path = os.path.join(self.directory, INDEX)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            index = {int(k): v for k, v in json.load(f).items()}
        return {s: v for s, v in index.items() if os.path.exists(self._path(s))}

    @staticmethod
    def _write(path: str, write) -> None:
        tmp = f"{path}.tmp{os.getpid()}"
        write(tmp)
        os.replace(tmp, path)

    def save(self, step: int, state: Any, val_loss: float, extra: Optional[dict] = None):
        """Writes ``state`` (an ``engine.TrainState``) at ``step``, then drops
        the checkpoints past the ``max_to_keep`` best; across cards every
        rank calls it, and rank 0 writes."""
        payload = {
            "step": int(state.step),
            "val_loss": float(val_loss),
            "params": dict(zip(state.params, _whole(state, list(state.params.values())))),
            "batch_stats": {k: v.detach().cpu() for k, v in state.batch_stats.items()},
            "opt_state": _opt_tree(state.opt_state, state),
            "extra": extra or {},
        }
        if not _distributed(state) or state.mesh.rank == 0:
            self._commit(step, payload, val_loss)
        if _distributed(state):
            dist.barrier()

    def _commit(self, step: int, payload: dict, val_loss: float) -> None:
        self._write(self._path(step), lambda tmp: torch.save(payload, tmp))
        index = self._index()
        index[step] = float(val_loss)
        dropped = _by_goodness(index)[:-self.max_to_keep]
        kept = {str(s): v for s, v in index.items() if s not in dropped}

        def write_index(tmp):
            with open(tmp, "w") as f:
                json.dump(kept, f)

        self._write(os.path.join(self.directory, INDEX), write_index)
        for old in dropped:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        return max(self._index(), default=None)

    def best_step(self) -> Optional[int]:
        order = _by_goodness(self._index())
        return order[-1] if order else None

    def all_steps(self) -> list[int]:
        return sorted(self._index())

    def restore(self, step: int, state: Any = None):
        """The checkpoint at ``step``: its raw dict when ``state`` is None,
        else ``state`` (an ``engine.TrainState`` of the same model and
        optimizer) with the checkpoint's values, its tensors (which the
        model aliases) copied in place."""
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if state is None:
            return payload
        for name in ("params", "batch_stats"):
            mine, saved = getattr(state, name), payload[name]
            if set(mine) != set(saved):
                raise ValueError(f"checkpoint {name} differ from the state's: "
                                 f"{sorted(set(mine) ^ set(saved))[:5]}")
            _copy_into([mine[k] for k in mine], [saved[k] for k in mine],
                       state if name == "params" else None)
        return dataclasses.replace(state, step=payload["step"], opt_state=_restore_opt(
            state.opt_state, payload["opt_state"], state))

    def restore_latest(self, state: Any = None):
        step = self.latest_step()
        return (None, None) if step is None else (step, self.restore(step, state))

    def restore_best(self, state: Any = None):
        step = self.best_step()
        return (None, None) if step is None else (step, self.restore(step, state))

    def extra(self, step: int) -> dict:
        """What ``save`` was given as ``extra`` at ``step``."""
        return torch.load(self._path(step), map_location="cpu", weights_only=True)["extra"]
