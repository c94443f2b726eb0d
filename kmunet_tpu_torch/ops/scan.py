"""Selective SSM scan (port of ``kmunet_tpu/ops/scan.py``).

``selective_scan`` runs Mamba's S6 recurrence with an fp32 state and its
gradient to all six inputs: K8 and its backward (``kernels/scan.py``) on a
CUDA tensor, their plain versions on a CPU tensor.
``selective_scan_sharded`` is the sequence-parallel scan: L cut over an
axis of the device mesh (``parallel.make_mesh``), each rank scanning its
chunk through ``selective_scan`` and the chunks joined by a prefix over the
ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmunet_tpu_torch.kernels.scan import selective_scan, selective_scan_plain
from kmunet_tpu_torch.parallel.collectives import (all_gather, copy_to_axis, gather_chunks,
                                                   scatter_chunks)

__all__ = ["selective_scan", "selective_scan_plain", "selective_scan_sharded"]


def selective_scan_sharded(x, dt, A, Bmat, Cmat, D, mesh, axis: str = "spatial",
                           batch_axis: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel selective scan: L cut across the ranks of the mesh
    axis ``axis``, as a two-level prefix scan (the JAX package's
    ``shard_map`` over ``axis``):

      1. each rank scans its chunk of L from a zero state (``selective_scan``:
         K8 on the card);
      2. the chunks' summaries -- the decay over the chunk, exp(A * S_T),
         and its final state -- are all-gathered over the axis (JAX's
         Hillis-Steele ``ppermute`` hops become one gather), and each rank
         combines those of the ranks before it into the state that enters
         its chunk, h_in;
      3. h_in is folded in: y_t += C_t . (exp(A * S_t) * h_in), with S the
         chunk's cumulative dt.

    Every exponent is A (negative) times a sum of dt (positive): no
    quotient of cumulative decays, which underflow. The final state and
    the fold-in are plain torch. Inputs and output as ``selective_scan``,
    whole on every rank of the axis (each rank's rows: ``batch_axis`` names
    the mesh axis the caller's batch is already cut on, which the scan
    leaves alone); the gradients to all six inputs come back whole on every
    rank through autograd-aware collectives. As in JAX, L not divisible by
    the axis size, or an axis of one rank, runs the plain scan.
    """
    n = mesh.shape[axis]
    if x.shape[1] % n != 0 or n == 1:
        return selective_scan(x, dt, A, Bmat, Cmat, D)
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of the mesh")
    ax = mesh.axis(axis)
    xs, dts, Bs, Cs = (scatter_chunks(t, ax, dim=1) for t in (x, dt, Bmat, Cmat))
    A, D = copy_to_axis(A, ax), copy_to_axis(D, ax)
    y = selective_scan(xs, dts, A, Bs, Cs, D)

    st = torch.promote_types(x.dtype, torch.float32)
    Af, dtf = A.to(st), dts.to(st)
    S = torch.cumsum(dtf, dim=1)                                    # (B, Lc, D), inclusive
    # The sum of dt past t, S_T - S_t, as a suffix sum: never below 0.
    suffix = torch.flip(torch.cumsum(torch.flip(dtf, [1]), dim=1), [1])
    after = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=1)
    inc = (dtf * xs.to(st))[..., None] * Bs.to(st)[:, :, None, :]   # (B, Lc, D, N)
    h_end = (torch.exp(after[..., None] * Af) * inc).sum(dim=1)     # this chunk's final state
    a_all = torch.exp(S[:, -1, :, None] * Af)                      # its decay, (B, D, N)

    summaries = all_gather(torch.stack([a_all, h_end]), ax)         # (n, 2, B, D, N)
    # Every rank builds the same graph (its backward's collectives must come
    # in the same order on every rank): the ranks after it are masked out.
    h_in = torch.zeros_like(h_end)
    for k in range(n):
        before = torch.tensor(k < ax.index, device=h_in.device)
        h_in = torch.where(before, summaries[k, 0] * h_in + summaries[k, 1], h_in)
    fold = torch.einsum("bln,bldn->bld", Cs.to(st), torch.exp(S[..., None] * Af) * h_in[:, None])
    return gather_chunks((y.to(st) + fold).to(y.dtype), ax, dim=1)
