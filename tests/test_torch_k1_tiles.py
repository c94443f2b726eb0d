"""K1's arithmetic, as csrc/kanconv.cu computes it, modelled in torch on the
CPU and held to the JAX package's kernel and to the port's plain version.

The model runs the kernel's arithmetic: per halo value the 9 terms in fp32
(silu(x); u = fma(x, 2.5, 5.5) rounded once; the 4 bases B_{j-3} .. B_j that
may be nonzero, from the fraction f = u - floor(u) by the uniform cubic
B-spline's pieces, the others 0), each split into bf16 hi = bf16(v) and lo =
bf16(v - hi); the weights read back from the wrapper's packed words
(``kanconv.packed_weights``, the order and lanes the kernel's mma fragments
take, channels padded to a multiple of 8 and F to a multiple of 8 with
zeros): w_hi, and w_lo where the weights are not bf16 (``weight_parts``);
the products a_hi w_hi + a_lo w_hi + a_hi w_lo summed exactly and rounded
once to fp32, then to the dtype (the tensor cores' fp32 accumulation order
is not modelled; the kernel adds each term's products, a chain of 9 or 18
mma.sync instructions, to its fp32 sums).

Held, at small shapes with C=3 and F=5, C=5 and F=17, KM_UNetV3-SH's
channel counts (16 -> 16, 16 -> 32, 32 -> 64, 64 -> 32) and C=128 (wider
than any model's KAN conv: where the split's margin under the fp32
tolerance would run out first), in the three x cases of
``chip_smoke.KAN_X_CASES``:
- in fp32, to ``fused_kanconv`` (the Pallas kernel, interpreted off the TPU)
  and ``kanconv_reference`` within 1e-4 abs (tests/test_torch_kanconv.py's
  bound) plus 1e-5 of the largest |value| (check_kanconv's relative part):
  the split leaves up to 2^-17 of each term, about 5e-6 of the output's
  scale over C x 81 terms (1.3e-4 at C=64, where the outputs reach 25);
- in fp32, bf16 and fp16 (xp and the weights rounded to the dtype), to the
  plain version in fp32 on the same rounded inputs within
  ``chip_smoke.check_kanconv``'s tolerance (1e-5 + 1e-5 of the largest
  |value|, plus one ulp of the dtype in bf16 and fp16).
``pytest -s`` prints each case's worst error over that tolerance with the
terms split and with each term rounded once to bf16: the evidence for the
split. The kernel itself is held to the plain version on the card
(chip_smoke.py, tests/test_torch_gpu.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from kmunet_tpu.kernels.kanconv_pallas import fused_kanconv as fused_kanconv_jax
from kmunet_tpu.kernels.kanconv_pallas import kanconv_reference
from kmunet_tpu_torch.kernels import kanconv
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ATOL = 1e-4
# (B, C, F, H, W): a ragged C=3 -> F=5, C=5 -> F=17 (a third tile of 8
# output channels), SH's four KAN convs' channel counts, and C=128.
SHAPES = {
    "c3_f5": (2, 3, 5, 7, 9),
    "c5_f17": (1, 5, 17, 6, 10),
    "enc1": (1, 16, 16, 8, 8),
    "enc2": (1, 16, 32, 6, 6),
    "enc3": (1, 32, 64, 5, 5),
    "dec1": (1, 64, 32, 5, 5),
    "c128": (1, 128, 16, 4, 4),
}
JAX_KERNEL_SHAPES = ("c3_f5", "c5_f17", "enc2")  # the interpreted kernel is slow to trace
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def terms(xp):
    """(B, C, 9, Hp, Wp) fp32: silu(x) and the 8 bases, as the kernel
    evaluates them."""
    x = xp.float()
    u = (x.double() * 2.5 + 5.5).float()  # one fma, rounded once
    inside = (u >= 0) & (u < 11)
    fl = torch.floor(u)
    f = u - fl
    g = 1.0 - f
    f2 = f * f
    f3 = f2 * f
    pieces = torch.stack([g * g * g / 6.0, (3.0 * f3 - 6.0 * f2 + 4.0) / 6.0,
                          (-3.0 * f3 + 3.0 * f2 + 3.0 * f + 1.0) / 6.0, f3 / 6.0])
    j = fl.long()
    bases = torch.zeros(x.shape[:2] + (8,) + x.shape[2:])
    for k in range(4):  # basis q = j - 3 + k
        q = j - 3 + k
        ok = inside & (q >= 0) & (q <= 7)
        bases.scatter_add_(2, q.clamp(0, 7).unsqueeze(2),
                           torch.where(ok, pieces[k], 0.0).unsqueeze(2))
    return torch.cat([(x / (1.0 + torch.exp(-x))).unsqueeze(2), bases], 2)


def unpacked_weights(base, spline):
    """(parts, F, C, 9 terms, 3, 3) fp32 read back from the wrapper's packed
    words by the lanes the kernel's B fragments take, the padding cut off."""
    Fo, C = base.shape[:2]
    parts = kanconv.weight_parts(base, spline)
    words = kanconv.packed_weights(base, spline, parts)  # (C8, tap, term, Fp8, P, g, l)
    pairs = words.contiguous().view(torch.bfloat16).float()  # (..., g, l, e)
    c8, fp8 = words.shape[0], words.shape[3]
    # channel 8k + 2l + e, output channel 8n + g
    w = pairs.view(c8, 9, 9, fp8, parts, 8, 4, 2).permute(4, 3, 5, 0, 6, 7, 2, 1)
    w = w.reshape(parts, fp8 * 8, c8 * 8, 9, 3, 3)
    return w[:, :Fo, :C]


def model(xp, base, spline, dtype, split=True):
    """K1's output in ``dtype`` for xp, base, spline holding the dtype's
    values; ``split=False`` rounds each term once to bf16."""
    a = terms(xp)
    hi = _bf16(a)
    lo = _bf16(a - hi) if split else torch.zeros_like(hi)
    w = unpacked_weights(base, spline)
    B, C = a.shape[:2]
    flat = lambda t: t.reshape(B, C * 9, *t.shape[3:]).double()  # noqa: E731
    wf = lambda t: t.reshape(t.shape[0], C * 9, 3, 3).double()  # noqa: E731
    out = F.conv2d(flat(hi + lo), wf(w[0]))
    if w.shape[0] == 2:
        out = out + F.conv2d(flat(hi), wf(w[1]))
    return out.float().to(dtype)


def _tolerance(want, dtype):
    """chip_smoke.check_kanconv's bound for an fp32 ``want``."""
    tol = 1e-5 + 1e-5 * want.abs().max()
    if dtype != torch.float32:
        tol = tol + chip_smoke.ulp_tolerance(torch, want, dtype)
    return torch.broadcast_to(tol, want.shape)


def _inputs(shape, case, seed):
    return chip_smoke.kan_inputs(torch, np.random.default_rng(seed), shape, case, "cpu")


@functools.cache
def _jax_fns():
    return jax.jit(fused_kanconv_jax), jax.jit(kanconv_reference)


def _jax_layout(xp, base, spline):
    return (xp.numpy().transpose(0, 2, 3, 1), base.numpy().transpose(2, 3, 1, 0),
            spline.numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("case", chip_smoke.KAN_X_CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fp32_model_matches_jax(shape, case):
    """The fp32 model (weights split into hi and lo) against the JAX
    package's reference and, at three shapes, its Pallas kernel."""
    xp, base, spline = _inputs(SHAPES[shape], case, seed=len(shape) + len(case))
    got = model(xp, base, spline, torch.float32).numpy().transpose(0, 2, 3, 1)
    kernel, reference = _jax_fns()
    args = _jax_layout(xp, base, spline)
    want = np.asarray(reference(*args))
    atol = ATOL + 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if shape in JAX_KERNEL_SHAPES:
        np.testing.assert_allclose(got, np.asarray(kernel(*args)), rtol=0, atol=atol)


@pytest.mark.parametrize("case", chip_smoke.KAN_X_CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_within_check_kanconv_tolerance(shape, case):
    """The model in fp32, bf16 and fp16 within check_kanconv's tolerance of
    the plain version on the same rounded inputs; prints each dtype's worst
    error over that tolerance with the terms split and rounded once."""
    xp32, base32, spline32 = _inputs(SHAPES[shape], case, seed=100 + len(shape) + len(case))
    ratios = {}
    for name, dtype in DTYPES.items():
        xp, base, spline = (t.to(dtype) for t in (xp32, base32, spline32))
        want = kanconv.kanconv_plain(xp.float(), base.float(), spline.float())
        tol = _tolerance(want, dtype)
        for split in (True, False):
            got = model(xp, base, spline, dtype, split).float()
            ratio = float(((got - want).abs() / tol).max())
            ratios[f"{name}{'' if split else ' single'}"] = ratio
            if split:
                assert ratio <= 1.0, f"{name}: {ratio:.3f} of the tolerance"
    print(f"\n{shape}/{case}: worst error / check_kanconv tolerance: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_packed_weights_hold_each_weight_once_in_its_lane(dtype):
    """Unpacked by the kernel's lanes, the packed words give back w_hi (and
    w_lo where the weights are not bf16) of every (f, c, term, tap), zeros
    in the padding, and hi + lo within 2^-16 of the weight."""
    _, base, spline = _inputs((1, 11, 13, 2, 2), "unit", seed=3)
    base, spline = base.to(dtype), spline.to(dtype)
    w = torch.cat([base.float().reshape(13, 11, 1, 3, 3),
                   spline.float().reshape(13, 11, 8, 3, 3)], 2)
    got = unpacked_weights(base, spline)
    assert got.shape[0] == (1 if dtype == torch.bfloat16 else 2)
    assert torch.equal(got[0], _bf16(w))
    whole = got.sum(0)
    assert float(((whole - w).abs() - 2.0 ** -16 * w.abs()).max()) <= 0.0
    words = kanconv.packed_weights(base, spline, got.shape[0])
    assert words.shape == (2, 9, 9, 2, got.shape[0], 8, 4)
    # (chunk, tap, term, n, part, g, l, e): f = 8n + g, channel 8 chunk + 2l + e
    pairs = words.contiguous().view(torch.bfloat16).float().view(*words.shape, 2)
    assert float(pairs[:, :, :, 1, :, 5:].abs().max()) == 0.0  # F padded from 13 to 16
    assert float(pairs[1, ..., 1, 1].abs().max()) == 0.0  # C padded from 11 to 16
    assert float(pairs[1, ..., 2:, :].abs().max()) == 0.0
