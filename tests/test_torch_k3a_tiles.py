"""K3a's passes, as csrc/hsmssd_ablate.cu computes them, modelled in torch on
the CPU and held to the port's plain version ``ablate_mix_plain``; and K5,
which runs K7's kernel with one view, through the K7 model of
tests/test_torch_k7_tiles.py, held to ``bilinear_gather_plain``.

The K3a model runs the kernel's decomposition: each TPU tile of ``tile``
tokens cut into spt slices of tps 64-token kernel tiles
(``ablate_mix._slices`` on an H100's 132 SMs); the tile-max pass's max(0,
max over a slice of dt, + A); per slice its M (full: the running max over
the slices of TPU tiles 0..j; bf16_e: tile j's), then per k-step of 16
tokens s = dt + A, e by the mode, w = bf16(e * Bm), the k-step's exact
products with x summed exactly and added to the fp32 accumulator with one
rounding (the tensor cores' accumulation order within a k-step is not
modelled), den summed in fp32; the merge's weight per TPU tile (full:
exp(M_j - M_last); bf16_e: exp(-the sum of the later tiles' m); 1
otherwise) applied by fused multiply-adds over the slices in order, hn =
bf16(h / (den + 1)); the scatter's exact products over 16 states a k-step,
each k-step added to fp32 with one rounding, y rounded once to bf16;
dma_only's tile sums. The exps are torch.exp, as the kernel's expf.

Checks, at ``chip_smoke.ABLATE_SHAPES``'s four small shapes (several tiles
of 64, C != N with N = 32, one tile with C = 24, C = 5 with N = 8) on
``chip_smoke.ablate_inputs``' draws, in all five modes: y within
``chip_smoke.check_ablate``'s bound (one bf16 ulp of the output's scale) of
the plain version; w the plain version's bit for bit (the slices' maxima
give each TPU tile the plain version's running max exactly: max(dt) + A is
max(dt + A) in fp32); hn the plain version's except where the two fp32
quotients, within 1e-5 of each other relative, straddle a bf16 rounding
boundary. The kernel itself is held to the plain version on the card
(chip_smoke.py, tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kmunet_tpu_torch.kernels import ablate_mix, bilinear
from tests.test_torch_k7_tiles import k7_model, lane_walk
from tests.torch_cases import GATHER_CASES, GATHER_SHAPES, gather_inputs

SMS = 132  # the H100's SMs
KT = ablate_mix.KTILE  # tokens per kernel tile
SHAPES = {k: v for k, v in chip_smoke.ABLATE_SHAPES.items() if k != "script"}
MODES = ablate_mix.MODES
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's tensors are small: one intra-op thread runs it as fast
    alone and does not contend with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(t):
    return t.to(BF16).float()


def _e(mode, s, m):
    """e by the mode, for s (B, T, N) and the slice's max m (B, N)."""
    if mode == "full":
        return torch.exp(s - m[:, None])
    if mode == "bf16_e":
        return _bf16(torch.exp(s - m[:, None]))
    return torch.exp(s) if mode == "no_max" else s


def k3a_model(mode, xt, dt, Bm, Cm, A, tile):
    """(y (B, C, L) bf16, w (B, L, N) or None, h / (den + 1) (B, N, C) fp32 or
    None) of the CUDA K3a's passes."""
    Bsz, C, L = xt.shape
    N = dt.shape[2]
    n_tiles, per_tile = L // tile, tile // KT
    spt, tps = ablate_mix._slices(Bsz, L, tile, SMS)
    x, d, bm, cm, a = (t.float() for t in (xt, dt, Bm, Cm, A))
    if mode == "dma_only":
        sums = cm.view(Bsz, n_tiles, tile, N)[:, :, :ablate_mix.DMA_TOKENS].sum((2, 3))
        y = sums.to(BF16)[:, None, :, None].expand(Bsz, C, n_tiles, tile).reshape(Bsz, C, L)
        return y, None, None
    slices = [(j, j * per_tile + k * tps, j * per_tile + min((k + 1) * tps, per_tile))
              for j in range(n_tiles) for k in range(spt)]
    # The tile-max pass: max(0, max over the slice of dt, + A).
    smax = torch.stack([(d[:, b * KT:e * KT].amax(1) + a).clamp_min(0.0)
                        for _, b, e in slices], 1)  # (B, S, N)
    w_all = torch.empty(Bsz, L, N)
    part_d, part_h = [], []
    for j, first, last in slices:
        if mode == "full":
            m = smax[:, :(j + 1) * spt].amax(1).clamp_min(0.0)
        else:
            m = smax[:, j * spt:(j + 1) * spt].amax(1).clamp_min(0.0)
        den = torch.zeros(Bsz, N)
        h = torch.zeros(Bsz, N, C)
        for t0 in range(first * KT, last * KT, 16):
            toks = slice(t0, t0 + 16)
            e = _e(mode, d[:, toks] + a, m)
            den = den + e.sum(1)
            w = _bf16(e * bm[:, toks])
            w_all[:, toks] = w
            h = (h.double() + torch.einsum("btn,bct->bnc", w.double(),
                                           x[:, :, toks].double())).float()
        part_d.append(den)
        part_h.append(h)
    # The merge: each TPU tile's weight.
    m_tile = smax.view(Bsz, n_tiles, spt, N).amax(2).clamp_min(0.0)
    if mode == "full":
        M = torch.cummax(m_tile, 1).values
        wt = torch.exp(M - M[:, -1:])
    elif mode == "bf16_e":
        later = torch.zeros(Bsz, n_tiles, N)
        for j in range(n_tiles - 2, -1, -1):
            later[:, j] = later[:, j + 1] + m_tile[:, j + 1]
        wt = torch.exp(-later)
    else:
        wt = torch.ones(Bsz, n_tiles, N)
    den = torch.zeros(Bsz, N)
    h = torch.zeros(Bsz, N, C)
    for (j, _, _), d_i, h_i in zip(slices, part_d, part_h):
        den = (d_i.double() * wt[:, j].double() + den.double()).float()
        h = (h_i.double() * wt[:, j, :, None].double() + h.double()).float()
    q = h / (den[..., None] + 1.0)
    hn = _bf16(q)
    # The scatter: 16 states a k-step.
    y = torch.zeros(Bsz, C, L)
    for n0 in range(0, N, 16):
        y = (y.double() + torch.einsum("bnc,bln->bcl", hn[:, n0:n0 + 16].double(),
                                       cm[..., n0:n0 + 16].double())).float()
    return y.to(BF16), w_all, q


def plain_w_q(mode, xt, dt, Bm, A, tile):
    """w (B, L, N) and h / (den + 1) (B, N, C) fp32 of ``ablate_mix_plain``'s
    loop (``kernels/ablate_mix.py``), which returns only y."""
    Bsz, C, L = xt.shape
    N = dt.shape[2]
    m, den, h = torch.zeros(Bsz, N), torch.zeros(Bsz, N), torch.zeros(Bsz, C, N)
    w_all = torch.empty(Bsz, L, N)
    for i in range(L // tile):
        toks = slice(i * tile, (i + 1) * tile)
        s = dt[:, toks].float() + A.float()
        if mode in ("full", "bf16_e"):
            m_new = torch.maximum(m, s.amax(1)) if mode == "full" else s.amax(1).clamp_min(0.0)
            scale = torch.exp(m - m_new)
            e = torch.exp(s - m_new[:, None])
            if mode == "bf16_e":
                e = _bf16(e)
            else:
                m = m_new
            den = den * scale + e.sum(1)
            h = h * scale[:, None]
        else:
            e = torch.exp(s) if mode == "no_max" else s
            den = den + e.sum(1)
        w = (e * Bm[:, toks].float()).to(BF16)
        w_all[:, toks] = w.float()
        h = h + torch.einsum("bct,btn->bcn", xt[:, :, toks].float(), w.float())
    return w_all, (h / (den[:, None] + 1.0)).transpose(1, 2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k3a_model_matches_plain(shape, mode):
    """y within check_ablate's bound; w bit for bit; hn but at boundaries."""
    args = chip_smoke.ablate_inputs(torch, SHAPES[shape], len(shape), "cpu")
    tile = SHAPES[shape][4]
    want = ablate_mix.ablate_mix_plain(mode, *args, tile).float()
    got, w, q = k3a_model(mode, *args, tile)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())) - 7)
    err = (got.float() - want).abs()
    assert float(err.max()) <= float(ulp), f"{float(err.max())} > one bf16 ulp {float(ulp)}"
    if mode == "dma_only":
        return
    w_plain, q_plain = plain_w_q(mode, *args[:3], args[4], tile)
    torch.testing.assert_close(w, w_plain, rtol=0, atol=0)
    differ = _bf16(q) != _bf16(q_plain)
    assert bool(((q - q_plain).abs()[differ] <= 1e-5 * q_plain.abs()[differ]).all())
    assert float(differ.float().mean()) < 0.01


def test_slices_stay_in_their_tpu_tile():
    """Each TPU tile's kernel tiles go to spt slices, all in that tile, each
    covered once: what lets a slice take its tile's max and weight."""
    for Bsz, _, L, _, tile in chip_smoke.ABLATE_SHAPES.values():
        spt, tps = ablate_mix._slices(Bsz, L, tile, SMS)
        per_tile = tile // KT
        assert spt * tps >= per_tile > (spt - 1) * tps


@pytest.mark.parametrize("case", GATHER_CASES)
@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_k5_is_k7_at_one_view(mode, shape, case):
    """K5's launcher runs K7's kernel with G = 1: the K7 model at one view
    (x, y (B, Ho, Wo) read as (B, 1, Ho, Wo)) within 1e-5 abs of the plain
    K5, the card tests' bound."""
    img, x, y = (torch.from_numpy(a) for a in gather_inputs(GATHER_SHAPES[shape], case))
    want = bilinear.bilinear_gather_plain(img, x, y, mode)
    got, _ = k7_model(img, x[:, None], y[:, None], mode)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nvec", [8, 16])
def test_k5_chunk_at_the_bridge(nvec):
    """At the bridge's B=128 K5 gets chunks of 15 entries (multiview_chunk at
    G = 1); its lanes blend each (entry, 16-byte vector) pair once, bf16
    (8 vectors an entry) and fp32 (16)."""
    K = bilinear.multiview_chunk(128, 1, 16, 16, SMS)
    assert K == 15
    pairs = [p for r in lane_walk(K, nvec) for p in r]
    assert pairs == [(e, v) for e in range(K) for v in range(nvec)]
    assert np.all([len(r) == 32 for r in lane_walk(K, nvec)[:-1]])
