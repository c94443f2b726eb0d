"""FLOP counts (port of ``kmunet_tpu/utils/flops.py``), on
``torch.utils.flop_counter.FlopCounterMode``.

The counter counts the products PyTorch runs (matmuls, convolutions,
attention) at their operation count, 2 per multiply-add; a convolution
counts its in-bounds taps only, as XLA's cost analysis does
(tests/test_flops.py's hand formula), where PyTorch's own formula counts the
padding's taps too. The hand-written
kernels are not PyTorch ops, so, as in the JAX package, their wrappers
report their *useful* operation count (the math a minimal sequential
implementation performs, not the kernel's internal formulation) through
``record_custom_flops``, collected by ``tally_custom_flops``. They record it
at the same points as the JAX wrappers, whether the CUDA kernel or its plain
version runs, so the CPU's count equals the card's: K5, K4 and K7 per
gather, K8 per scan; K1-K3 record nothing, as in JAX.

A wrapper runs its work inside ``custom_call(n)``: what the counter counts
there (the plain versions' own products, such as the plain scan's einsum)
is taken back out, so that the recorded figure is not counted twice. With
no count open, ``custom_call`` is a shared ``nullcontext``: the wrappers'
calls on the training path do no bookkeeping.

    flops_of(fn, *args)      -> {"flops", "bytes_accessed", "custom_flops"}
    lowered_flops(fn, *args) -> the same, on meta copies of the arguments
"""

from __future__ import annotations

import contextlib
import copy
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

_TALLY: Optional[list] = None
_SESSION: Optional["_Session"] = None


class _Session:
    """One count: its counter, and what the counter counted inside the
    kernels' wrappers."""

    def __init__(self, counter: FlopCounterMode):
        self.counter = counter
        self.inside = 0


def record_custom_flops(n: float) -> None:
    """Called by a kernel's wrapper with the kernel's useful FLOP count for
    the given shapes."""
    if _TALLY is not None:
        _TALLY.append(float(n))


_IDLE = contextlib.nullcontext()


def custom_call(n: float):
    """A kernel wrapper's work: records ``n`` (``record_custom_flops``), and
    takes what the counter counts inside back out of the count."""
    # Every count (``_count``) opens a tally around its session.
    return _IDLE if _TALLY is None else _counted_call(n)


@contextlib.contextmanager
def _counted_call(n: float):
    record_custom_flops(n)
    session = _SESSION
    before = session.counter.get_total_flops() if session is not None else 0
    try:
        yield
    finally:
        if session is not None:
            session.inside += session.counter.get_total_flops() - before


class tally_custom_flops:
    """Context manager collecting the custom FLOPs recorded inside it::

        with tally_custom_flops() as t:
            model(x)
        t.total
    """

    def __enter__(self):
        global _TALLY
        self._prev = _TALLY
        _TALLY = []
        self._records = _TALLY
        return self

    def __exit__(self, *exc):
        global _TALLY
        _TALLY = self._prev
        return False

    @property
    def total(self) -> float:
        return float(sum(self._records))

    @property
    def records(self) -> list:
        """Each recorded figure, in the order of the calls."""
        return list(self._records)


@functools.lru_cache(maxsize=None)
def _valid_taps(n: int, k: int, stride: int, pad: int, dilation: int) -> int:
    """The kernel taps that land inside an axis of ``n``, summed over the
    output positions."""
    out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride - pad + j * dilation < n)


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
               out_shape=None, **kwargs) -> int:
    """2 x batch x out channels x in channels a group x the in-bounds taps."""
    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    dims = len(x_shape) - 2
    taps = math.prod(_valid_taps(x_shape[2 + i], w_shape[2 + i], stride[i], padding[i],
                                 dilation[i]) for i in range(dims))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


_CONV_OPS = {torch.ops.aten.convolution: _conv_flop, torch.ops.aten._convolution: _conv_flop}


def _count(fn, args) -> dict:
    global _SESSION
    counter = FlopCounterMode(display=False, custom_mapping=_CONV_OPS)
    session, outer = _Session(counter), _SESSION
    with tally_custom_flops() as t:
        _SESSION = session
        try:
            with counter:
                fn(*args)
        finally:
            _SESSION = outer
    # PyTorch's counter sees no bytes: -1, as the JAX package's _cost_dict
    # reports an unknown figure.
    return {"flops": float(counter.get_total_flops() - session.inside),
            "bytes_accessed": -1.0, "custom_flops": t.total}


def flops_of(fn, *args) -> dict:
    """Runs ``fn(*args)`` and returns {'flops', 'bytes_accessed',
    'custom_flops'}: the products PyTorch ran (the kernels' wrappers' plain
    work left out), -1 (unknown), and the kernels' useful FLOPs that their
    wrappers recorded."""
    return _count(fn, args)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).to("meta")
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def lowered_flops(fn, *args) -> dict:
    """``flops_of`` without doing the work: ``fn`` runs on meta copies of
    ``args`` (tensors, and modules passed as arguments; the kernels'
    wrappers take their plain versions' shapes on a meta tensor). The count
    is ``flops_of``'s: it depends on the shapes alone. An op that takes no
    meta tensor raises, as it does on the meta device."""
    return _count(fn, _to_meta(args))
