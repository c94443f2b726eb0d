"""Profiling helpers (the port of ``kmunet_tpu/utils/profiler.py``, which
imports JAX): ``trace(log_dir)``, a ``torch.profiler`` trace of the CPU and
the card written under ``log_dir``, and ``chained_time_ms``, step timing
with chained calls."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block with ``torch.profiler`` (the CPU, and CUDA where a
    card is present) and writes its trace (Chrome trace JSON, which
    TensorBoard's profiler plugin and Perfetto read) under ``log_dir``;
    yields the profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)


def chained_time_ms(apply_fn: Callable, *xs, iters: int = 50, warmup: int = 2) -> float:
    """Mean time per call of ``apply_fn(*xs)`` in ms over ``iters`` chained
    calls after ``warmup`` ones, as the JAX package's ``chained_time_ms``
    chains them: each call's first floating input is multiplied by (1 +
    1e-20 c), c the running sum of the previous results' means, so that no
    call can be skipped or reordered; the perturbation and the means are
    timed with the calls. On a CUDA input the time is taken between CUDA
    events (the device's time, host gaps included); on a CPU input by the
    host's clock."""
    first = next((i for i, x in enumerate(xs)
                  if isinstance(x, torch.Tensor) and x.is_floating_point()), None)
    if first is None:
        raise ValueError("chained_time_ms needs a floating tensor among the inputs")
    device = xs[first].device

    def call(c):
        args = list(xs)
        args[first] = args[first] * (1.0 + 1e-20 * c).to(args[first].dtype)
        means = [t.float().mean() for t in _leaves(apply_fn(*args)) if t.is_floating_point()]
        return c + sum(means) / max(len(means), 1)

    c = torch.zeros((), device=device)
    for _ in range(warmup):
        c = call(c)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            c = call(c)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            c = call(c)
        ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(c)):
        raise FloatingPointError(f"chained_time_ms: the results' means sum to {float(c)}")
    return ms / iters
