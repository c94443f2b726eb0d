"""K2's and K3's tiled passes, as csrc/hsmssd.cu computes them, modelled in
torch on the CPU and held to the JAX package's kernels and to the port's
plain versions.

The model runs the kernels' arithmetic: L cut into tiles of T tokens (the
last one ragged) and the tiles into slices of ``tps``; per slice and tile
the max of dt over the tile's tokens plus A, m_new = max(m, that), scale =
exp(m - m_new) (0 on the first tile), s = dt + A and e = exp(s - m_new) in
fp32, d = d * scale + sum e, w = e * B in fp32, split as the kernels split
it before the tensor cores (bf16: w = w_hi + w_lo, two bf16 values; fp16:
two TF32 parts, x exact; fp32: 3xTF32, x split too; TF32 rounds to nearest,
ties away, as cvt.rna.tf32.f32), the tile's products summed exactly and
rounded once to fp32 (the tensor cores' fp32 accumulation order is not
modelled), h = fma(h, scale, tile); the merge over the slices in order,
the gated MLP in fp32, h2 rounded to the dtype, and the scatter y = h2^T C
from the rounded h2 (exact products in bf16 and fp16, 3xTF32 in fp32), y
rounded to the dtype. The exps are torch.exp, not the kernels'
ex2.approx.

T is shrunk to 16 (the mma's k-step; the kernels' is 64) so that L = T - 1,
T + 1, 1 and several slices stay small, with N of 4 (padded to 16 in the
kernels) and 64, C of 3 and 64, and the ``seeded`` and ``large`` dt of
``chip_smoke.mixer_inputs``; one case runs the kernels' own tile. Past 64
channels or states the kernels take their wide path: a padded odd N (9,
16 rows with dt = A = B = 0 in the padded ones, as N = 4) and C = 72, more
than one 64-channel chunk of the compress, whose chunks' sums are those of
the narrow compress, channel by channel; the merge writes h in fp32 and the
gated MLP runs as two tiled products on the tensor cores in 3xTF32
(a_hi w_hi + a_lo w_hi + a_hi w_lo), which the model sums exactly and
rounds once to fp32, as for the compress's products.

Tolerances. fp32: h within 1e-4 abs of ``hsmssd_compress_op`` (the Pallas
kernel, interpreted off the TPU; tests/test_kernels.py's bound), y and h2
within 1e-5 relative and absolute of ``hsmssd_mix(..., interpret=True)``
(tests/test_ssd_mix.py's); the wide cases' y within check_mixer's fp32
bound of it (the Pallas kernel's own fp32 lies 2.1e-5 from float64 there).
bf16 and fp16: within ``chip_smoke.check_mixer``'s tolerance of the plain
versions on the same rounded inputs (1e-5 + 1e-5 of
the largest |value| + one ulp of the dtype, y also one ulp of each h2
carried through the scatter). ``pytest -s`` prints, per case, how far the
bf16 model lands against that tolerance with w split and with w rounded
once to bf16, as the TPU kernel rounds it: the evidence for the split. The
kernels themselves are held to the plain versions on the card
(chip_smoke.py, tests/test_torch_gpu.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from kmunet_tpu.kernels.ssd_mix_pallas import hsmssd_mix as hsmssd_mix_jax
from kmunet_tpu.kernels.ssd_pallas import hsmssd_compress_op
from kmunet_tpu_torch.kernels import ssd
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

T_MODEL = 16  # the model's tile (the kernels' kT is 64)
KERNEL_T = ssd.TILE
# (B, C, L, N, T, tps): L = T - 1, T + 1, 1 and three slices of two tiles
# (the last ragged) at N of 4 and 64, C of 3 and 64; and the kernels' tile.
CASES = {
    "l15_c3_n4": (2, 3, 15, 4, T_MODEL, 2),
    "l17_c64_n64": (1, 64, 17, 64, T_MODEL, 1),
    "l1_c3_n64": (2, 3, 1, 64, T_MODEL, 1),
    "l83_c64_n4_slices": (2, 64, 83, 4, T_MODEL, 2),
    "l83_c3_n64_slices": (1, 3, 83, 64, T_MODEL, 2),
    "kernel_tile_l193": (1, 16, 3 * KERNEL_T + 1, 64, KERNEL_T, 2),
    "wide_l33_c72_n9": (2, 72, 33, 9, T_MODEL, 2),
    "wide_l49_c96_n25_kernel_tile": (1, 96, 49, 25, KERNEL_T, 1),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _tf32(t):
    """t rounded to TF32 (10 bits of mantissa, to nearest, ties away from
    zero), as cvt.rna.tf32.f32 rounds it."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _products(pairs, spec):
    """sum of einsum(spec, a, b) over the pairs, exactly, rounded once to fp32."""
    return sum(torch.einsum(spec, a.double(), b.double()) for a, b in pairs).float()


def _split_pairs(w, x, mode):
    """(w part, x part) pairs whose products the kernels add, per dtype."""
    if mode == "bf16":
        hi = _bf16(w)
        return [(hi, x), (_bf16(w - hi), x)]
    hi = _tf32(w)
    lo = _tf32(w - hi)
    if mode == "fp16":
        return [(hi, x), (lo, x)]
    if mode == "fp32":
        xh = _tf32(x)
        return [(hi, xh), (lo, xh), (hi, _tf32(x - xh))]
    assert mode == "bf16_single"  # the TPU kernel's one rounding of w
    return [(_bf16(w), x)]


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def compress_model(x, dt, Bm, A, T, tps, mode):
    """h (B, N, C) fp32 as the compress and merge passes compute it; x (B, C,
    L), dt and B (B, N, L) fp32 holding the dtype's values, A (N,) fp32."""
    Bsz, C, L = x.shape
    N = dt.shape[1]
    tiles = -(-L // T)
    parts = []
    for first in range(0, tiles, tps):
        m = torch.full((Bsz, N), -torch.inf)
        d = torch.zeros(Bsz, N)
        h = torch.zeros(Bsz, N, C)
        for tile in range(first, min(tiles, first + tps)):
            sl = slice(tile * T, min(L, tile * T + T))
            m_new = torch.maximum(m, dt[:, :, sl].amax(-1) + A)
            scale = torch.exp(m - m_new)
            e = torch.exp(dt[:, :, sl] + A[:, None] - m_new[..., None])
            d = d * scale + e.sum(-1)
            w = e * Bm[:, :, sl]
            h = _fma(h, scale[..., None], _products(_split_pairs(w, x[:, :, sl], mode),
                                                    "bnt,bct->bnc"))
            m = m_new
        parts.append((m, d, h))
    m = torch.stack([p[0] for p in parts]).amax(0)
    d_sum = torch.zeros(Bsz, N)
    h_sum = torch.zeros(Bsz, N, C)
    for m_i, d_i, h_i in parts:
        wgt = torch.exp(m_i - m)
        d_sum = _fma(d_i, wgt, d_sum)
        h_sum = _fma(wgt[..., None], h_i, h_sum)
    return h_sum / d_sum[..., None]


def _mlp_products(a, w):
    """a (B, N, K) . w^T, w (O, K), as the wide path's tiled products: 3xTF32,
    summed exactly and rounded once to fp32."""
    ah, wh = _tf32(a), _tf32(w)
    return _products([(ah, wh), (_tf32(a - ah), wh), (ah, _tf32(w - wh))], "bnk,ok->bno")


def mix_model(x, dt, Bm, Cm, A, w_hz, w_out, D, T, tps, mode, dtype):
    """(y, h2) in ``dtype`` as K3's passes compute them: the gated MLP in
    fp32 in the merge (the narrow path), or as two 3xTF32 products (the
    wide path: C or N past ``ssd.NARROW``)."""
    C, N = x.shape[1], dt.shape[1]
    h = compress_model(x, dt, Bm, A, T, tps, "bf16" if mode == "bf16_single" else mode)
    wide = C > ssd.NARROW or N > ssd.NARROW
    hz = _mlp_products(h, w_hz) if wide else h @ w_hz.T
    hv, z = hz[..., :C], hz[..., C:]
    gated = hv * (z * torch.sigmoid(z)) + hv * D
    h2 = (_mlp_products(gated, w_out) if wide else gated @ w_out.T).to(dtype)
    h2f = h2.float()
    if mode == "fp32":
        hh, ch = _tf32(h2f), _tf32(Cm)
        pairs = [(hh, ch), (_tf32(h2f - hh), ch), (hh, _tf32(Cm - ch))]
    else:
        pairs = [(h2f, Cm)]
    return _products(pairs, "bnc,bnl->bcl").to(dtype), h2


def _inputs(shape, dt_case, seed):
    """chip_smoke's mixer inputs (fp32, the port's layout), dt, B, C split."""
    Bsz, C, L, N, _, _ = shape
    x, bcdt, A, w_hz, w_out, D = chip_smoke.mixer_inputs(
        torch, np.random.default_rng(seed), (Bsz, C, L, N), dt_case, "cpu")
    Bm, Cm, dt = (t.contiguous() for t in bcdt.split(N, dim=1))
    return x, dt, Bm, Cm, A, w_hz, w_out, D


@functools.cache
def _jax_fns():
    return (jax.jit(hsmssd_compress_op),
            jax.jit(functools.partial(hsmssd_mix_jax, interpret=True)))


def _tolerance(want, dtype, h2=None, Cm=None):
    """chip_smoke.check_mixer's bound for an output ``want`` (fp32)."""
    tol = 1e-5 + 1e-5 * want.abs().max()
    if dtype != torch.float32:
        tol = tol + chip_smoke.ulp_tolerance(torch, want, dtype)
        if h2 is not None:
            tol = tol + torch.einsum("bnc,bnl->bcl",
                                     chip_smoke.ulp_tolerance(torch, h2.float(), dtype),
                                     Cm.abs())
    return torch.broadcast_to(tol, want.shape)


@pytest.mark.parametrize("dt_case", ["seeded", "large"])
@pytest.mark.parametrize("case", list(CASES))
def test_fp32_model_matches_jax_kernels(case, dt_case):
    """The fp32 (3xTF32) model against the Pallas kernels, interpreted."""
    shape = CASES[case]
    T, tps = shape[4:]
    x, dt, Bm, Cm, A, w_hz, w_out, D = _inputs(shape, dt_case, seed=len(case))
    compress_jax, mix_jax = _jax_fns()
    tr = lambda t: t.numpy().transpose(0, 2, 1)  # noqa: E731
    want_h = np.asarray(compress_jax(tr(x), tr(dt), tr(Bm), A.numpy()))
    got_h = compress_model(x, dt, Bm, A, T, tps, "fp32")
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=1e-4)
    want_y, want_h2 = mix_jax(x.numpy(), tr(dt), tr(Bm), tr(Cm), A.numpy(), w_hz.numpy().T,
                              w_out.numpy().T, D.numpy()[0])
    got_y, got_h2 = mix_model(x, dt, Bm, Cm, A, w_hz, w_out, D, T, tps, "fp32", torch.float32)
    if case.startswith("wide"):
        # y sums 9-25 states of |h2 C| up to 20 into elements near 0: there
        # the Pallas kernel's fp32 lies up to 2.1e-5 from float64 (the
        # model's 1.6e-5), so y is held to check_mixer's fp32 bound.
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                                   atol=1e-5 + 1e-5 * float(np.abs(want_y).max()))
    else:
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h2.numpy(), np.asarray(want_h2).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt_case", ["seeded", "large"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_within_check_mixer_tolerance(case, dt_case):
    """The bf16 and fp16 models (and the fp32 one) within check_mixer's
    tolerance of the plain versions on the same rounded inputs; prints the
    bf16 model's worst error over its tolerance with w split and with w
    rounded once."""
    shape = CASES[case]
    T, tps = shape[4:]
    args32 = _inputs(shape, dt_case, seed=100 + len(case))
    x32, dt32, B32, C32, A, w_hz, w_out, D = args32
    ratios = {}
    for name, dtype in DTYPES.items():
        x, dt, Bm, Cm = (t.to(dtype) for t in (x32, dt32, B32, C32))
        want_h = ssd.hsmssd_compress_plain(x, dt, Bm, A).float()
        want_y, want_h2 = ssd.hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D)
        xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
        modes = [name] + (["bf16_single"] if name == "bf16" else [])
        for mode in modes:
            got_h = compress_model(xf, dtf, Bf, A, T, tps, mode).to(dtype).float()
            got_y, got_h2 = mix_model(xf, dtf, Bf, Cf, A, w_hz, w_out, D, T, tps, mode, dtype)
            worst = 0.0
            for label, got, want, tol in (
                    ("h", got_h, want_h, _tolerance(want_h, dtype)),
                    ("h2", got_h2.float(), want_h2.float(), _tolerance(want_h2.float(), dtype)),
                    ("y", got_y.float(), want_y.float(),
                     _tolerance(want_y.float(), dtype, want_h2, Cf))):
                ratio = float(((got - want).abs() / tol).max())
                worst = max(worst, ratio)
                if mode != "bf16_single":
                    assert ratio <= 1.0, f"{name} {label}: {ratio:.3f} of the tolerance"
            ratios[mode] = worst
    print(f"\n{case}/{dt_case}: worst error / check_mixer tolerance: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
