"""A model's activations sharded on image rows over the mesh's 'spatial'
axis (KM_UNetV3, ConvLSTM, TrajGRU, Mamba-UNet): what GSPMD inserts for
the JAX package's ``P("data", None, "spatial", None)`` batch, written out.

Each rank of a spatial group holds one contiguous block of image rows,
block i on spatial index i (``row_range``; ``mesh.row_sharding`` cuts a
batch so). Every op of the model is
one of three kinds:

- local: 1x1 convs, elementwise ops, work along W and over channels;
- halo: a conv taller than one row reads ``halo_rows`` of its neighbours
  (``conv2d``, ``halo_conv2d``: strided and dilated ones too;
  ``conv_transpose2d``), as do the window DySample, DAGEM's rolls along H
  (a ring: the reference wraps) and Mamba's causal conv1d over the tokens
  (the row-major tokens of a block of rows are a chunk of the sequence);
- global: means and norms over H*W (``spatial_mean``, ``group_norm``) and
  the HSM-SSD softmax over L are summed over the axis (``all_reduce_sum``),
  and a gather whose source rows are arbitrary reads the whole source
  (``all_gather_rows``).

The modules find the axis in a context that the model's ``forward`` enters
(``sharded_rows`` of the model's ``row_axis``), so that a recompute under
``torch.utils.checkpoint`` finds it too. Outside it every
helper is the plain op.

Two gathers, two gradients (``parallel/collectives.py``): ``all_gather``
hands each rank the sum of the ranks' gradients of its slot, right where
each rank does its own work with the whole tensor (a gather source feeding
this rank's output rows); ``gather_chunks`` hands each rank its slice of a
gradient that every rank holds whole, right where every rank computes the
same thing from it (the loss of the whole frames). The wrong one is off by
exactly the shard count.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kmunet_tpu_torch.parallel.collectives import _active, all_gather, all_reduce_, all_reduce_sum
from kmunet_tpu_torch.parallel.collectives import gather as _gather

_ROWS: contextvars.ContextVar = contextvars.ContextVar("kmunet_rows", default=None)
HALO_MODES = ("zeros", "wrap", "replicate")


@contextlib.contextmanager
def sharded_rows(axis):
    """Inside, ``row_axis()`` is ``axis`` (a ``mesh.Axis`` of the 'spatial'
    axis, or None: the plain ops)."""
    token = _ROWS.set(axis if _active(axis) else None)
    try:
        yield
    finally:
        _ROWS.reset(token)


def row_axis():
    """The spatial axis the current forward's rows are sharded over, or None."""
    return _ROWS.get()


def row_range(axis, rows: int) -> tuple[int, int]:
    """(first, end) global rows of this rank's block of ``rows`` rows."""
    if axis is None:
        return 0, rows
    return axis.index * rows, (axis.index + 1) * rows


def _source_rows(index: int, n_ranks: int, h: int, top: int, bottom: int, mode: str):
    """For each halo row (the ``top`` rows above the block of rank ``index``
    of ``n_ranks``, then the ``bottom`` rows below it): (rank, row in that
    rank's block), or None for a zero row."""
    H, row0 = h * n_ranks, index * h
    out = []
    for g in [row0 - top + t for t in range(top)] + [row0 + h + t for t in range(bottom)]:
        if mode == "wrap":
            g %= H
        elif mode == "replicate":
            g = min(max(g, 0), H - 1)
        elif not 0 <= g < H:
            out.append(None)
            continue
        out.append((g // h, g % h))
    return out


@functools.lru_cache(maxsize=None)
def _slots(index: int, n_ranks: int, h: int, top: int, bottom: int, mode: str,
           device: torch.device) -> torch.Tensor:
    """Each halo row's index in the ranks' stacked edges (rank r's first k
    rows, then its last k, at 2k r), or the zero row at the end; made once
    per shape on ``device`` (a copy from the host would wait for the
    device)."""
    k = min(max(top, bottom), h)
    sources = _source_rows(index, n_ranks, h, top, bottom, mode)
    slots = []
    for src in sources:
        if src is None:
            slots.append(2 * k * n_ranks)
            continue
        r, i = src
        slots.append(2 * k * r + (i if i < k else k + i - (h - k)))
    return torch.tensor(slots, device=device)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, top, bottom, mode, dim):
        h = x.shape[dim]
        k = min(max(top, bottom), h)
        ctx.axis, ctx.top, ctx.bottom, ctx.dim, ctx.h, ctx.k = axis, top, bottom, dim, h, k
        edges = torch.cat([x.narrow(dim, 0, k), x.narrow(dim, h - k, k)], dim).movedim(dim, 0)
        every = _gather(edges.contiguous(), axis, dim=0)  # (S * 2k, ...)
        every = torch.cat([every, every.new_zeros((1,) + every.shape[1:])])
        ctx.slots = _slots(axis.index, axis.size, h, top, bottom, mode, x.device)
        halo = every.index_select(0, ctx.slots).movedim(0, dim)
        return torch.cat([halo.narrow(dim, 0, top), x, halo.narrow(dim, top, bottom)], dim)

    @staticmethod
    def backward(ctx, grad):
        dim, h, k, top, bottom = ctx.dim, ctx.h, ctx.k, ctx.top, ctx.bottom
        halo = torch.cat([grad.narrow(dim, 0, top), grad.narrow(dim, top + h, bottom)], dim)
        halo = halo.movedim(dim, 0)
        n = 2 * k * ctx.axis.size
        sums = halo.new_zeros((n + 1,) + halo.shape[1:]).index_add_(0, ctx.slots, halo)[:n]
        mine = all_reduce_(sums.contiguous(), ctx.axis).narrow(0, 2 * k * ctx.axis.index, 2 * k)
        mine = mine.movedim(0, dim)
        dx = grad.narrow(dim, top, h).clone()
        dx.narrow(dim, 0, k).add_(mine.narrow(dim, 0, k))
        dx.narrow(dim, h - k, k).add_(mine.narrow(dim, k, k))
        return dx, None, None, None, None, None


def halo_rows(x: torch.Tensor, axis, top: int, bottom: int, mode: str = "zeros",
              dim: int = 2) -> torch.Tensor:
    """This rank's block of rows (along ``dim``) with the ``top`` rows above
    it and the ``bottom`` rows below it in the global image, from the
    neighbouring ranks' blocks (several ranks' where a halo is taller than
    a block). Past the global edges the rows are zeros (``mode="zeros"``),
    the other edge's (``"wrap"``, a ring) or the edge row repeated
    (``"replicate"``). The backward adds each halo row's gradient into the
    row it was read from. One all-gather of the blocks' edge rows forward,
    one all-reduce backward. Without an axis (None, or no group) the rows
    come from ``x`` itself, as the one process pads them."""
    if mode not in HALO_MODES:
        raise ValueError(f"mode must be one of {HALO_MODES}, got {mode!r}")
    if top == 0 and bottom == 0:
        return x
    if not _active(axis):
        if mode == "wrap":
            return torch.cat([x.narrow(dim, x.shape[dim] - top, top), x, x.narrow(dim, 0, bottom)],
                             dim)
        pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [top, bottom]
        return F.pad(x, pad, mode="constant" if mode == "zeros" else "replicate")
    return _HaloRows.apply(x, axis, top, bottom, mode, dim % x.dim())


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                padding=(0, 0), groups: int = 1, stride=(1, 1), dilation=(1, 1)) -> torch.Tensor:
    """``F.conv2d`` with zero ``padding`` (ph, pw) of the global image: under
    ``row_axis()`` the rows its output rows read above and below this
    rank's block come from the neighbours (``halo_rows``) and only the
    columns are padded. At row stride s the block's rows must be a multiple
    of s, and the global image must give s times fewer output rows, so that
    each rank writes the output rows of its own input rows: the block takes
    the ph rows above it and the d(kh - 1) - ph - s + 1 below it (none where
    that is negative), which the whole image's conv reads for those rows."""
    ph, pw = padding
    axis = row_axis()
    if axis is None:
        return F.conv2d(x, weight, bias, stride, (ph, pw), dilation, groups)
    s, d, kh = stride[0], dilation[0], weight.shape[2]
    h = x.shape[2]
    H = h * axis.size
    if h % s or (H + 2 * ph - d * (kh - 1) - 1) // s + 1 != H // s:
        raise ValueError(f"a conv of kernel {kh}, stride {s}, dilation {d}, padding {ph} on "
                         f"{h} of {H} rows a rank: each rank's output rows must be its own "
                         "input rows' (rows a multiple of the stride, H / stride out)")
    top, bottom = ph, max(d * (kh - 1) - ph - s + 1, 0)
    return F.conv2d(halo_rows(x, axis, top, bottom), weight, bias, stride, (0, pw), dilation,
                    groups)


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for a zero-padded ``nn.Conv2d``, its rows padded from
    the neighbours under ``row_axis()`` (``halo_conv2d``: strided and
    dilated convs too)."""
    if row_axis() is None or conv.kernel_size[0] == 1 and conv.stride[0] == 1:
        return conv(x)
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
        raise NotImplementedError(f"{conv}: the row halo takes convs with numeric zero padding")
    return halo_conv2d(x, conv.weight, conv.bias, conv.padding, conv.groups, conv.stride,
                       conv.dilation)


def conv_transpose2d(conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for an ``nn.ConvTranspose2d`` whose output is s times its
    input along the rows (kh - 2 ph = s, no output padding or dilation).
    Under ``row_axis()`` each rank writes the s * h output rows of its h
    input rows: input row i reaches output rows s i - ph .. s i - ph + kh - 1,
    so the block takes the (kh - 1 - ph) // s rows above it and
    1 + (ph - 1) // s below it from the neighbours (zeros past the image's
    edges), and the rows of the transposed conv of the taller block are
    cropped to its own. The global ``padding`` crops the image's first and
    last rows on the first and last rank; on every other rank the crop
    drops the halo rows' contributions."""
    axis = row_axis()
    if axis is None:
        return conv(x)
    (kh, _), (s, _), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    if kh - 2 * ph != s or conv.output_padding[0] or conv.dilation[0] != 1:
        raise NotImplementedError(f"{conv}: the row halo takes transposed convs whose rows "
                                  "grow by the stride (kernel - 2 padding = stride)")
    top, bottom = (kh - 1 - ph) // s, 1 + (ph - 1) // s
    h = x.shape[2]
    y = F.conv_transpose2d(halo_rows(x, axis, top, bottom), conv.weight, conv.bias, conv.stride,
                           (0, pw), (0, conv.output_padding[1]), conv.groups, conv.dilation)
    return y.narrow(2, s * top + ph, s * h)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C): the mean over the global image's H*W (summed
    in at least fp32 over the ranks under ``row_axis()``)."""
    axis = row_axis()
    if axis is None:
        return x.mean(dim=(2, 3))
    total = all_reduce_sum(x.to(torch.promote_types(x.dtype, torch.float32)).sum(dim=(2, 3)),
                           axis)
    return (total / (x.shape[2] * axis.size * x.shape[3])).to(x.dtype)


def group_norm(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn(x)``, with the statistics of the global image under ``row_axis()``:
    its mean, then its biased variance about that mean (two sums over the
    ranks, in at least fp32)."""
    axis = row_axis()
    if axis is None:
        return gn(x)
    B, C = x.shape[:2]
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(B, gn.num_groups, -1)
    n = xf.shape[-1] * axis.size
    mean = all_reduce_sum(xf.sum(-1), axis)[..., None] / n
    centred = xf - mean
    var = all_reduce_sum(centred.square().sum(-1), axis)[..., None] / n
    y = (centred * torch.rsqrt(var + gn.eps)).reshape(x.shape)
    if gn.affine:
        shape = (1, C) + (1,) * (x.dim() - 2)
        y = y * gn.weight.view(shape) + gn.bias.view(shape)
    return y.to(x.dtype)


def all_gather_rows(x: torch.Tensor, axis, dim: int = 2) -> torch.Tensor:
    """The whole image from the ranks' blocks of rows along ``dim``, on every
    rank, for a gather whose source rows are arbitrary; the backward sums
    the ranks' gradients of each block into its owner (``all_gather``)."""
    if not _active(axis):
        return x
    return torch.cat(all_gather(x, axis).unbind(0), dim)
