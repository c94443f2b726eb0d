"""NaN guard (port of ``kmunet_tpu/utils/nan_guard.py``): the reference's
forward-hook NaN detector (train_shanghai.py:287-294, nan_hook).

``nan_hooks(model)`` registers that hook on every submodule; it reads each
output back from the device, so it is a debugging aid: nothing on the
trainer's path turns it on.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping

import torch
from torch import nn


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))


def assert_finite(tree, where: str = "") -> None:
    """Raises ``ValueError`` naming the first leaf of ``tree`` (a tensor, or
    nested dicts, lists and tuples of them: a ``state_dict``, a step's
    metrics) that holds a NaN or an Inf."""
    for name, leaf in _leaves(tree):
        if leaf.is_floating_point() or leaf.is_complex():
            if not bool(torch.isfinite(leaf).all()):
                raise ValueError(f"non-finite values in {where}{name}")


@contextlib.contextmanager
def nan_hooks(model: nn.Module):
    """Inside, every submodule of ``model`` raises ``ValueError`` naming its
    path in the model (``model.named_modules``) when a floating output of
    its forward holds a NaN (the counterpart of the JAX package's
    ``nan_hook_interceptor``)::

        with nan_hooks(model):
            model(x)
    """
    def hook(name):
        def check(module, args, output):
            for _, leaf in _leaves(output):
                if leaf.is_floating_point() and bool(torch.isnan(leaf).any()):
                    raise ValueError(f"NaN detected in {name or type(module).__name__}")
        return check

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
    try:
        yield model
    finally:
        for h in handles:
            h.remove()


def guard(step: Callable) -> Callable:
    """Wraps a train step (``(state, metrics) = step(...)``) so that a NaN
    loss in its metrics raises ``ValueError`` (it reads the loss back)."""

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        metrics = out[1] if isinstance(out, tuple) and len(out) > 1 and isinstance(
            out[1], dict) else None
        if metrics and "loss" in metrics and bool(torch.isnan(torch.as_tensor(metrics["loss"]))):
            raise ValueError("NaN detected in train loss")
        return out

    return wrapped
