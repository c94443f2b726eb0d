"""K6's tap-owner formulation, as csrc/bilinear_gather_backward.cu computes
it, modelled in numpy and held to ``jax.vjp`` of the JAX package's XLA
gathers (``bilinear_gather_xla``, ``bilinear_gather_grouped_xla``,
``bilinear_gather_multiview_xla``) on the CPU.

The model runs the kernel's passes on the kernel's index arithmetic: the
unit pass (d_x and d_y, each unit's anchor cell in its segment's (H+1) x
(W+1) grid with an offset of one, no bin for a unit whose taps all miss the
image in zeros mode), and per segment ((b, group), or (b, view) for the
shared source) the counts and their exclusive scan, the fill by a cursor in
an arbitrary order (a seeded permutation stands for the atomics' schedule)
followed by the sort of each bin into ascending u, and the owner pass, in
which source pixel (i, j) walks the bins of the anchors (i-1, j-1),
(i-1, j), (i, j-1), (i, j) of each of its segments (all G views for the
shared source): one tap of each unit lands there, weighted by the product
of its fractions, except in border mode on the last row or column, where
x1 = min(x0+1, W-1) lands a unit's near and far taps on the same pixel. It
also counts the landings: every tap that lies in the image is added by
exactly one owner, once. All three entries (G = 1, grouped, shared-source),
both modes, tests/torch_cases.py's coordinate cases and shapes, fp32, within
1e-5 abs + 1e-5 relative, as tests/test_torch_bilinear_backward.py holds the
plain version. The kernel itself is held to the plain version on the card
(chip_smoke.py, tests/test_torch_gpu.py).
"""

import functools

import jax
import numpy as np
import pytest

from kmunet_tpu.ops.sample import (
    bilinear_gather_grouped_xla,
    bilinear_gather_multiview_xla,
    bilinear_gather_xla,
)
from tests.torch_cases import (
    GATHER_CASES,
    GATHER_SHAPES,
    GROUPED_SHAPES,
    MULTIVIEW_SHAPES,
    gather_inputs,
    grouped_inputs,
    multiview_inputs,
)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = ("zeros", "border")
TOL = dict(rtol=1e-5, atol=1e-5)
f32 = np.float32


def _taps(xr, yr, H, W, zeros):
    """The forward's taps of each coordinate pair: x0, y0, x1, y1 (int) and
    the fractions wx, wy (fp32), clamped as the kernel's ``taps`` clamps."""
    if zeros:
        x = np.minimum(np.maximum(xr, f32(-2)), f32(W + 1))
        y = np.minimum(np.maximum(yr, f32(-2)), f32(H + 1))
    else:
        x = np.minimum(np.maximum(xr, f32(0)), f32(W - 1))
        y = np.minimum(np.maximum(yr, f32(0)), f32(H - 1))
    x0f, y0f = np.floor(x), np.floor(y)
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    x1 = x0 + 1 if zeros else np.minimum(x0 + 1, W - 1)
    y1 = y0 + 1 if zeros else np.minimum(y0 + 1, H - 1)
    return x0, y0, x1, y1, (x - x0f).astype(f32), (y - y0f).astype(f32)


def _clip_vjp(v, lo, hi):
    """jnp.clip's VJP: half the cotangent at a tie."""
    f = np.where(v > lo, 1.0, np.where(v == lo, 0.5, 0.0))
    m = np.maximum(v, f32(lo))
    return (f * np.where(m < hi, 1.0, np.where(m == hi, 0.5, 0.0))).astype(f32)


def owner_model(img, x, y, g, mode, shared, seed=0):
    """(d_img, d_x, d_y) by the kernel's passes: img (B, H, W, C), x and y
    (B, G, Ho, Wo), g (B, Ho, Wo, C), or (B, Ho, Wo, G*C) when ``shared``."""
    zeros = mode == "zeros"
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    HoWo = Ho * Wo
    S = 1 if shared else G  # owners per source pixel
    Cg = C // S  # channels of a unit's block of g
    cells = (H + 1) * (W + 1)
    nq = B * G * HoWo
    q = np.arange(nq)  # the units' coordinates, [b, group (view), output pixel]
    seg, p = q // HoWo, q % HoWo  # a segment per (b, group (view))
    b, grp = seg // G, seg % G
    u_of = (b * HoWo + p) * G + grp  # the unit's block of g: g.reshape(-1, Cg)[u]
    x0, y0, x1, y1, wx, wy = _taps(x.reshape(-1), y.reshape(-1), H, W, zeros)

    # Pass 1: d_x, d_y; the anchor cells.
    gq = g.reshape(-1, Cg)[u_of]  # (units, Cg)
    src = img.reshape(B, H * W, S, Cg)
    sgrp = np.zeros_like(grp) if shared else grp

    def tap(ty, tx):
        inside = (ty >= 0) & (ty <= H - 1) & (tx >= 0) & (tx <= W - 1)
        v = src[b, np.clip(ty, 0, H - 1) * W + np.clip(tx, 0, W - 1), sgrp]
        return v * inside[:, None]

    v00, v01, v10, v11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
    wx_, wy_ = wx[:, None], wy[:, None]
    d_x = (gq * ((v01 - v00) * (1 - wy_) + (v11 - v10) * wy_)).sum(-1, dtype=f32)
    d_y = (gq * ((v10 - v00) * (1 - wx_) + (v11 - v01) * wx_)).sum(-1, dtype=f32)
    if not zeros:
        d_x = d_x * _clip_vjp(x.reshape(-1), 0.0, W - 1)
        d_y = d_y * _clip_vjp(y.reshape(-1), 0.0, H - 1)
    binned = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    cell = np.where(binned, (y0 + 1) * (W + 1) + (x0 + 1), -1)

    # Pass 2, per segment: the counts, their exclusive scan, the fill by a
    # cursor in the atomics' (any) order, which leaves offs[c] at the end of
    # bin c, the sort of each bin into ascending u, the weights, and the
    # offsets shifted back.
    counts = np.zeros((B * G, cells + 1), np.int64)
    np.add.at(counts, (seg[binned], cell[binned]), 1)
    offs = np.concatenate([np.zeros((B * G, 1), np.int64), np.cumsum(counts, 1)[:, :-1]], 1)
    bins = np.full(nq, -1, np.int64)
    for k in np.random.default_rng(seed).permutation(q[binned]):
        bins[seg[k] * HoWo + offs[seg[k], cell[k]]] = u_of[k]
        offs[seg[k], cell[k]] += 1
    offs = np.concatenate([np.zeros((B * G, 1), np.int64), offs[:, :-1]], 1)
    for sg in range(B * G):
        for c in range(cells):
            lo, hi = sg * HoWo + offs[sg, c], sg * HoWo + offs[sg, c + 1]
            bins[lo:hi] = np.sort(bins[lo:hi])
    assert sorted(bins[bins >= 0]) == sorted(u_of[binned])
    q_of = np.empty(nq, np.int64)
    q_of[u_of] = q
    wts = {e: (wx[q_of[u]], wy[q_of[u]]) for e, u in enumerate(bins) if u >= 0}

    # Pass 3: each source pixel owns its sum, over its segments in order.
    d_img = np.zeros((B, H, W, C), f32)
    landed = np.zeros(nq, np.int64)
    for bi in range(B):
        for s in range(S):
            for i in range(H):
                for j in range(W):
                    one_tap = zeros or (i < H - 1 and j < W - 1)
                    acc = np.zeros(Cg, f32)
                    for sg in range(bi * G + s, bi * G + s + G // S):
                        for rr in (0, 1):  # anchors on row i - 1, then row i
                            c = (i + rr) * (W + 1) + j
                            lo, mid, hi = (sg * HoWo + offs[sg, c + k] for k in range(3))
                            for e in range(lo, hi):
                                u = bins[e]
                                a, bw = wts[e]
                                x0e, y0e = (j - 1 if e < mid else j), i - 1 + rr
                                assert (x0e, y0e) == (x0[q_of[u]], y0[q_of[u]])
                                gu = g.reshape(-1, Cg)[u]
                                if one_tap:
                                    wt = f32((a if e < mid else 1 - a) * (1 - bw if rr else bw))
                                    acc += gu * wt
                                    landed[q_of[u]] += 1
                                    continue
                                x1e, y1e = min(x0e + 1, W - 1), min(y0e + 1, H - 1)
                                for ty, tx, w in ((y0e, x0e, (1 - a) * (1 - bw)),
                                                  (y0e, x1e, a * (1 - bw)),
                                                  (y1e, x0e, (1 - a) * bw), (y1e, x1e, a * bw)):
                                    if ty == i and tx == j:
                                        acc += gu * f32(w)
                                        landed[q_of[u]] += 1
                    d_img[bi, i, j, s * Cg:(s + 1) * Cg] = acc
    inside = sum(((ty >= 0) & (ty <= H - 1) & (tx >= 0) & (tx <= W - 1)).astype(np.int64)
                 for ty, tx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    np.testing.assert_array_equal(landed, inside)
    return d_img, d_x.reshape(x.shape), d_y.reshape(y.shape)


_XLA = {"gather": bilinear_gather_xla, "grouped": bilinear_gather_grouped_xla,
        "multiview": bilinear_gather_multiview_xla}


@functools.cache
def _vjp(entry, mode):
    """``jax.vjp`` of an XLA gather, jitted: one compile per shape."""
    def fn(img, x, y, g):
        _, vjp = jax.vjp(lambda i, a, b: _XLA[entry](i, a, b, mode), img, x, y)
        return vjp(g)

    return jax.jit(fn)


def _jax_vjp(entry, mode, img, x, y, g):
    return [np.asarray(a) for a in _vjp(entry, mode)(img, x, y, g)]


def _assert_grads(got, want):
    for name, a, b in zip(("d_img", "d_x", "d_y"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_owner_model_matches_xla_vjp(mode, shape, case):
    """G = 1: the backward of K5."""
    img, x, y = gather_inputs(GATHER_SHAPES[shape], case)
    g = np.random.default_rng(100).normal(size=x.shape + (img.shape[-1],)).astype(f32)
    d_img, d_x, d_y = owner_model(img, x[:, None], y[:, None], g, mode, shared=False)
    want = _jax_vjp("gather", mode, img, x, y, g)
    _assert_grads((d_img, d_x[:, 0], d_y[:, 0]), want)


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GROUPED_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_owner_model_matches_grouped_xla_vjp(mode, shape, case):
    """Grouped: the backward of K4, one segment per (b, group)."""
    img, x, y, g = grouped_inputs(GROUPED_SHAPES[shape], case)
    got = owner_model(img, x, y, g, mode, shared=False)
    want = _jax_vjp("grouped", mode, img, x, y, g)
    _assert_grads(got, want)


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(MULTIVIEW_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_owner_model_matches_multiview_xla_vjp(mode, shape, case):
    """Shared source: the backward of K7, one segment per b whose bins hold
    the units of all G views."""
    img, x, y, g = multiview_inputs(MULTIVIEW_SHAPES[shape], case)
    got = owner_model(img, x, y, g, mode, shared=True)
    want = _jax_vjp("multiview", mode, img, x, y, g)
    _assert_grads(got, want)


def test_owner_model_is_independent_of_the_fill_order():
    """The sort makes each bin's order, and so every sum, independent of
    the order in which the atomics hand out the slots."""
    img, x, y, g = multiview_inputs(MULTIVIEW_SHAPES["g13_c16"], "spread")
    runs = [owner_model(img, x, y, g, "zeros", shared=True, seed=s) for s in (0, 1)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
