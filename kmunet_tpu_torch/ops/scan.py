"""Selective SSM scan (port of ``kmunet_tpu/ops/scan.py``).

``selective_scan`` runs Mamba's S6 recurrence with an fp32 state and its
gradient to all six inputs: K8 and its backward (``kernels/scan.py``) on a
CUDA tensor, their plain versions on a CPU tensor.
``selective_scan_sharded`` is the sequence-parallel scan: L cut over an
axis of the device mesh (``parallel.make_mesh``), each rank scanning its
chunk through ``selective_scan_chunk``: ``selective_scan`` on its tokens,
joined to the chunks before it by a prefix over the ranks. On sharded
image rows (``parallel/halo.py``) a rank's tokens are its chunk already,
and the model calls ``selective_scan_chunk`` on them.
"""

from __future__ import annotations

from typing import Optional

import torch

from kmunet_tpu_torch.kernels.scan import selective_scan, selective_scan_plain
from kmunet_tpu_torch.parallel.collectives import (_active, all_gather, copy_to_axis,
                                                   gather_chunks, scatter_chunks)

__all__ = ["selective_scan", "selective_scan_chunk", "selective_scan_plain",
           "selective_scan_sharded"]


def selective_scan_sharded(x, dt, A, Bmat, Cmat, D, mesh, axis: str = "spatial",
                           batch_axis: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel selective scan: L cut across the ranks of the mesh
    axis ``axis``, as a two-level prefix scan (the JAX package's
    ``shard_map`` over ``axis``): each rank takes its chunk of L
    (``scatter_chunks``) and scans it with ``selective_scan_chunk``, and
    the chunks' outputs are gathered back (``gather_chunks``).

    Inputs and output as ``selective_scan``, whole on every rank of the
    axis (each rank's rows: ``batch_axis`` names the mesh axis the caller's
    batch is already cut on, which the scan leaves alone); the gradients to
    all six inputs come back whole on every rank through autograd-aware
    collectives (``A`` and ``D``, which every rank uses whole on its chunk,
    through ``copy_to_axis``). As in JAX, L not divisible by the axis size,
    or an axis of one rank, runs the plain scan.
    """
    n = mesh.shape[axis]
    if x.shape[1] % n != 0 or n == 1:
        return selective_scan(x, dt, A, Bmat, Cmat, D)
    if batch_axis is not None and batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} is not an axis of the mesh")
    ax = mesh.axis(axis)
    xs, dts, Bs, Cs = (scatter_chunks(t, ax, dim=1) for t in (x, dt, Bmat, Cmat))
    y = selective_scan_chunk(xs, dts, copy_to_axis(A, ax), Bs, Cs, copy_to_axis(D, ax), ax)
    return gather_chunks(y, ax, dim=1)


def selective_scan_chunk(x, dt, A, Bmat, Cmat, D, axis) -> torch.Tensor:
    """The selective scan of a sequence cut into contiguous chunks of tokens
    over the ranks of ``axis`` (a ``mesh.Axis``; chunk i on index i), of
    this rank's chunk as it is: x, dt (B, Lc, D), Bmat, Cmat (B, Lc, N) its
    tokens, A (D, N) and D (D,) the parameters. The chunks may differ in
    length. Returns this rank's (B, Lc, D) of the whole sequence's scan:

      1. the rank scans its chunk from a zero state (``selective_scan``:
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
    the fold-in are plain torch. The gradients are this rank's part: the
    summaries' reach their owners through ``all_gather``'s backward, and
    ``A`` and ``D`` get only what this rank's tokens give them (the caller
    sums them over the axis: ``copy_to_axis``, or the trainer's gradient
    sum over 'spatial' on sharded image rows). Without a group the plain
    scan."""
    if not _active(axis):
        return selective_scan(x, dt, A, Bmat, Cmat, D)
    y = selective_scan(x, dt, A, Bmat, Cmat, D)

    st = torch.promote_types(x.dtype, torch.float32)
    Af, dtf = A.to(st), dt.to(st)
    S = torch.cumsum(dtf, dim=1)                                    # (B, Lc, D), inclusive
    # The sum of dt past t, S_T - S_t, as a suffix sum: never below 0.
    suffix = torch.flip(torch.cumsum(torch.flip(dtf, [1]), dim=1), [1])
    after = torch.cat([suffix[:, 1:], torch.zeros_like(suffix[:, :1])], dim=1)
    inc = (dtf * x.to(st))[..., None] * Bmat.to(st)[:, :, None, :]   # (B, Lc, D, N)
    h_end = (torch.exp(after[..., None] * Af) * inc).sum(dim=1)     # this chunk's final state
    a_all = torch.exp(S[:, -1, :, None] * Af)                      # its decay, (B, D, N)

    summaries = all_gather(torch.stack([a_all, h_end]), axis)       # (n, 2, B, D, N)
    # Every rank builds the same graph (its backward's collectives must come
    # in the same order on every rank): the ranks after it are masked out.
    h_in = torch.zeros_like(h_end)
    for k in range(axis.size):
        before = torch.tensor(k < axis.index, device=h_in.device)
        h_in = torch.where(before, summaries[k, 0] * h_in + summaries[k, 1], h_in)
    fold = torch.einsum("bln,bldn->bld", Cmat.to(st), torch.exp(S[..., None] * Af) * h_in[:, None])
    return (y.to(st) + fold).to(y.dtype)
